"""The port's post-mortem CLI (``torchft_tpu_torch/diagnose.py``) against
the JAX package's (``torchft_tpu/diagnose.py``).

Every input kind of tests/test_diagnose.py is written once and read by both
packages' ``main([... "--json"])``: flight dumps, event files, lighthouse
timelines and link matrices, ``.prov`` fragment hops and trace spans.  The
two reports must be equal key for key.  Then the port's selftest and exit
codes, its phase vocabulary against what the port's Manager records, and a
chaos smoke mirroring ``TestDiagnoseChaosSmoke`` on port Managers: replica_1
killed at step 2 by the port's fault layer, named by both packages.
"""

import json
import re
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from torchft_tpu import diagnose as jdiag
from torchft_tpu_torch import diagnose as tdiag
from torchft_tpu_torch import manager as tmanager
from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.parallel.process_group import ProcessGroupTCP
from torchft_tpu_torch.utils import faults
from torchft_tpu_torch.utils import flightrecorder as fr
from torchft_tpu_torch.utils.faults import FaultRule, InjectedFault

ROOT = Path(__file__).resolve().parent.parent
S = 1_000_000_000  # 1 s in ns
T0 = 1_000 * S


def _rec(op, start_ns, end_ns, replica_id, status="ok", **fields):
    return {"flight": "rec", "op": op, "status": status, "start_ns": start_ns,
            "end_ns": end_ns, "replica_id": replica_id, **fields}


def _jsonl(path, objs):
    path.write_text("".join(json.dumps(o) + "\n" for o in objs))
    return str(path)


def _span(name, trace, sid, parent, t0_ms, t1_ms, ok=True, **attrs):
    return {"name": name, "trace_id": trace, "span_id": sid,
            "parent_span_id": parent, "start_ns": t0_ms * 1_000_000,
            "end_ns": t1_ms * 1_000_000, "attributes": attrs, "ok": ok}


def _timeline_doc(worst, n_steps=1):
    return {
        "quorum_id": 3, "now_ms": 1_000_000, "ring": 256,
        "steps_tracked": n_steps,
        "steps": [
            {"step": 40 + i, "replicas": 4, "reports": 4,
             "first_ms": 999_000, "last_ms": 999_100, "span_ms": 100,
             "phases": {"ring": {"n": 4, "mean_ms": 12.0, "max_ms": 30.0}},
             "codec_busy_s": 0.4, "wire_busy_s": 0.8}
            for i in range(n_steps)
        ],
        "stragglers_worst": worst,
    }


def _straggler(rid, step, score, stale=False, lag=3):
    return {"replica_id": rid, "step": step, "step_lag": lag,
            "progress_age_ms": 9000, "straggler_score": score,
            "inflight_op": "wedged", "stale": stale}


def _links_doc(slow_goodput):
    rows = [
        {"src": f"h{i}", "peer": f"h{i + 1}", "plane": "heal", "local": False,
         "goodput_bps": 1.0e9, "rtt_p99_ms": 2.0, "samples": 20}
        for i in range(4)
    ]
    rows.append({"src": "h7", "peer": "h8", "plane": "heal", "local": False,
                 "goodput_bps": slow_goodput, "rtt_p99_ms": 40.0, "samples": 12})
    rows.append({"src": "h0", "peer": "h0", "plane": "ici", "local": True,
                 "goodput_bps": 5.0e10, "rtt_p99_ms": 0.01, "samples": 50})
    return {"version": 3, "hosts": 9, "rows_total": len(rows), "rows": rows}


def _ledger_spans():
    T = "a" * 32
    ra, rb = "ra" + "0" * 14, "rb" + "0" * 14
    return [
        _span("quorum_round", T, ra, None, 0, 1000, replica_id="rep_a", step=5, quorum_id=2),
        _span("quorum_rpc", T, "p1" + "0" * 14, ra, 0, 100, replica_id="rep_a", step=5),
        _span("ring", T, "p2" + "0" * 14, ra, 100, 900, replica_id="rep_a", step=5),
        _span("quant.pipeline", T, "p3" + "0" * 14, ra, 100, 900,
              collective="allreduce", codec_s=0.25, wire_s=0.55),
        _span("quorum_round", T, rb, None, 0, 400, replica_id="rep_b", step=5, quorum_id=2),
        _span("commit", T, "p4" + "0" * 14, rb, 0, 300, replica_id="rep_b", step=5),
        _span("heal_manifest", T, "p5" + "0" * 14, rb, 300, 350, replica_id="rep_b", step=5),
        _span("heal.recv", T, "p6" + "0" * 14, rb, 300, 390, replica_id="rep_b"),
    ]


# ---------------------------------------------------------------------------
# every input kind, written once and read by both packages
# ---------------------------------------------------------------------------


def case_selftest_dumps(tmp):
    a, b = jdiag._synthetic_dumps(str(tmp))
    return [a, b]


def case_injected_fault(tmp):
    return [_jsonl(tmp / "d.jsonl", [
        _rec("quorum_rpc", T0, T0 + S, "a", step=2),
        _rec("fault", T0 + 2 * S, T0 + 2 * S, "b", status="fault", step=2,
             fault="train.step:raise", site="train.step", action="raise"),
        _rec("allreduce", T0 + 3 * S, T0 + 10 * S, "a", status="error", step=2,
             reason="peer closed"),
    ])]


def case_recovered_fault_then_death(tmp):
    recs = [_rec("fault", T0, T0, "a", status="fault", step=1,
                 fault="transport.recv:raise", site="transport.recv", action="raise")]
    for step in range(1, 10):
        for rid in ("a", "b"):
            if rid == "b" and step >= 8:
                continue
            recs.append(_rec("ring", T0 + step * S, T0 + step * S + 1000, rid, step=step))
    recs.append(_rec("allreduce", T0 + 8 * S, T0 + 18 * S, "a", status="error",
                     step=8, reason="deadline"))
    return [_jsonl(tmp / "d.jsonl", recs)]


def case_healthy_run(tmp):
    recs = [_rec("ring", T0 + st * S, T0 + st * S + 1000, rid, step=st)
            for st in range(5) for rid in ("a:u0", "b:u1")]
    recs.append(_rec("commit", T0 + 8 * S, T0 + 8 * S, "a:u0", step=4))
    return [_jsonl(tmp / "d.jsonl", recs)]


def case_phantom_fault_id(tmp):
    recs = [_rec("fault", T0 + S, T0 + S, "b", status="fault", step=1,
                 fault="train.step:raise", site="train.step", action="raise")]
    recs += [_rec("ring", T0 + st * S, T0 + st * S + 1000, rid, step=st)
             for st in range(5) for rid in ("a:u0", "b:u1")]
    return [_jsonl(tmp / "d.jsonl", recs)]


def case_one_sided_evidence(tmp):
    return [_jsonl(tmp / "d.jsonl", [
        _rec("quorum_rpc", T0, T0 + S, "a:u1", step=4, quorum_id=2),
        _rec("allreduce", T0 + 2 * S, T0 + 12 * S, "a:u1", status="error",
             rank=0, world=2, recv_peer=1, reason="collective failed: timeout"),
    ])]


def case_retry_storm(tmp):
    return [_jsonl(tmp / "d.jsonl", [
        _rec("retry", T0 + i, T0 + i, "a", status="retry", retry_op="rpc.connect",
             attempt=i)
        for i in range(5)
    ])]


def case_rejected_plan(tmp):
    return [_jsonl(tmp / "d.jsonl", [
        _rec("quorum_rpc", T0, T0 + S, "a:u0", step=3),
        _rec("plan.verify", T0 + S, T0 + S, "b:u1", status="error", step=3,
             verdict="reject", plane="heal", invariant="coverage",
             detail="fragment 4 has no source"),
    ])]


def case_events_merge(tmp):
    rec = _rec("allreduce", 5, 9, "a", status="error", step=1)
    dump = _jsonl(tmp / "d.jsonl", [rec, rec, {"flight": "meta", "reason": "x"}])
    (tmp / "d.jsonl").write_text((tmp / "d.jsonl").read_text() + "not json\n")
    events = _jsonl(tmp / "ev.jsonl", [
        {"ts": 1.0, "kind": "quorum", "message": "quorum changed",
         "replica_id": "a", "step": 1, "quorum_id": 3},
        {"ts": 2.0, "kind": "error", "message": "boom", "replica_id": "b",
         "step": 1},
    ])
    return [dump, "--events", events]


def case_timeline_straggler(tmp):
    doc = _timeline_doc([_straggler("stub007:u2", 38, 18.0),
                         _straggler("stub001:u0", 41, 1.1, lag=0)], n_steps=3)
    return ["--timeline", _jsonl(tmp / "tl.json", [doc])]


def case_timeline_stale_beside_dumps(tmp):
    recs = [_rec("quorum_rpc", T0 + st * S, T0 + st * S + 10**6, rid, step=st,
                 quorum_id=1)
            for rid, last in (("replica_a:u1", 5), ("replica_b:u2", 1))
            for st in range(last)]
    recs.append(_rec("allreduce", T0 + 5 * S, T0 + 6 * S, "replica_a:u1",
                     status="error", step=4, quorum_id=1, reason="peer gone"))
    doc = _timeline_doc([_straggler("unrelated:u9", 2, 30.0, stale=True)])
    return [_jsonl(tmp / "a.jsonl", recs), "--timeline", _jsonl(tmp / "tl.json", [doc])]


def case_links_slow_with_trace(tmp):
    return ["--links", _jsonl(tmp / "links.json", [_links_doc(1.0e8)]),
            "--trace", _jsonl(tmp / "trace.jsonl", _ledger_spans())]


def case_links_healthy(tmp):
    return ["--links", _jsonl(tmp / "links.json", [_links_doc(0.9e9)])]


def case_prov_poisoned_hop(tmp):
    return [jdiag._synthetic_prov_dump(str(tmp)), "--fragment", "weights/0"]


def case_prov_clean_heal(tmp):
    recs = [
        _rec("fragment.hold", T0, T0, "", frag="model/3", version=6,
             digest8="bbbbbbbb", holder="g0:0", role="source"),
        _rec("fragment.hop", T0 + S, T0 + 2 * S, "", frag="model/3", version=6,
             source="http://g0:0", plane="heal", verdict="ok", bytes=1 << 20,
             first_byte_ms=0.3, holder="g1:1"),
        _rec("fragment.hop", T0 + S, T0 + 2 * S, "", frag="model/4", version=6,
             source="http://g0:0", plane="heal", verdict="ok", bytes=1 << 20,
             first_byte_ms=0.3, holder="g1:1"),
    ]
    return [_jsonl(tmp / "flight.jsonl.prov", recs), "--fragment", "model/3"]


def case_trace_ledger(tmp):
    return ["--trace", _jsonl(tmp / "trace.jsonl", _ledger_spans())]


def case_trace_lighthouse_wait(tmp):
    T = "b" * 32
    r0 = "r0" + "0" * 14
    return ["--trace", _jsonl(tmp / "trace.jsonl", [
        _span("quorum_round", T, r0, None, 0, 1000, replica_id="rep_a", step=1, quorum_id=1),
        _span("quorum_wait", T, "w0" + "0" * 14, r0, 0, 900, replica_id="rep_a", step=1),
        _span("rpc.quorum", T, "l0" + "0" * 14, r0, 0, 700, server="lighthouse",
              method="quorum"),
    ])]


def case_trace_error(tmp):
    T = "c" * 32
    spans = [
        _span("quorum_round", T, "r0" + "0" * 14, None, 0, 500, replica_id="rep_a",
              step=2, quorum_id=1),
        _span("quorum_round", T, "r1" + "0" * 14, None, 0, 400, ok=False,
              replica_id="rep_bad", step=2, quorum_id=1),
    ]
    path = _jsonl(tmp / "trace.jsonl", spans)
    with open(path, "a") as fh:
        fh.write('{"not": "a span"}\n')
    return ["--trace", path]




def case_trace_tied_steps(tmp):
    return ["--trace", _jsonl(tmp / "trace.jsonl", _tied_spans(wire_ms=500, commit_ms=300))]


def _tied_spans(wire_ms, commit_ms):
    """Two steps, one dominated by ``wire``, one by ``protocol``: a tie."""
    spans = []
    for step, (name, ms) in enumerate((("ring", wire_ms), ("commit", commit_ms))):
        t, r = f"{step:x}" * 32, f"r{step}" + "0" * 14
        spans += [
            _span("quorum_round", t, r, None, 0, 1000, replica_id="rep_a", step=step,
                  quorum_id=1),
            _span(name, t, f"p{step}" + "0" * 14, r, 0, ms, replica_id="rep_a", step=step),
        ]
    return spans


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


def _report(main, argv, capsys):
    assert main(argv + ["--json"]) == 0
    return json.loads(capsys.readouterr().out)


def assert_same_report(port, jax):
    """The port's report is the JAX package's, key for key, but for the
    ledger's ``dominant_overall`` on a tie between categories, which the
    JAX package breaks by its interpreter's string hash seed: there the
    port's choice must be one of the tied categories."""
    port, jax = json.loads(json.dumps(port)), json.loads(json.dumps(jax))
    if "trace_ledger" in jax:
        dominants = [s["dominant"] for s in jax["trace_ledger"]["steps"] if s["dominant"]]
        top = max(map(dominants.count, dominants), default=0)
        tied = {d for d in dominants if dominants.count(d) == top}
        if len(tied) > 1:
            assert port["trace_ledger"].pop("dominant_overall") in tied
            assert jax["trace_ledger"].pop("dominant_overall") in tied
    assert port == jax


@pytest.mark.parametrize("case", sorted(CASES))
def test_json_report_equals_the_jax_packages(case, tmp_path, capsys):
    argv = CASES[case](tmp_path)
    want = _report(jdiag.main, argv, capsys)
    got = _report(tdiag.main, argv, capsys)
    assert_same_report(got, want)
    # and the text renderings agree but for the program's name (a tie's
    # overall category shows in the trace section's header)
    assert jdiag.main(argv) == 0
    jtext = capsys.readouterr().out.replace("torchft-diagnose", "torchft-torch-diagnose")
    assert tdiag.main(argv) == 0
    if got.get("trace_ledger", {}).get("dominant_overall") == (
            want.get("trace_ledger", {}).get("dominant_overall")):
        assert capsys.readouterr().out == jtext


@pytest.mark.parametrize("wire_ms,commit_ms,want", [(500, 300, "wire"),
                                                    (300, 500, "protocol"),
                                                    (400, 400, "wire")])
def test_a_tie_in_the_ledger_goes_to_the_category_with_more_seconds(wire_ms, commit_ms, want):
    """One step dominated by wire and one by protocol: the overall category
    is the one with more critical-path seconds (then the first in
    LEDGER_CATEGORIES), whatever the order the spans come in."""
    spans = _tied_spans(wire_ms, commit_ms)
    for order in (spans, spans[::-1], spans[2:] + spans[:2]):
        report = tdiag.analyze_trace(order)
        assert sorted(s["dominant"] for s in report["steps"]) == ["protocol", "wire"]
        assert report["dominant_overall"] == want


def test_each_case_exercises_its_signal(tmp_path, capsys):
    """The inputs above reach every signal the report can name, so the
    parity test covers each branch of the attribution."""
    signals = set()
    for name, fn in CASES.items():
        sub = tmp_path / name
        sub.mkdir()
        report = _report(tdiag.main, fn(sub), capsys)
        if report["culprit"]:
            signals.add(report["culprit"]["signal"])
        if name == "links_slow_with_trace":
            assert report["trace_ledger"]["steps"][0]["wire_slow_link"] == "h7->h8"
        if name == "prov_clean_heal":
            journey = report["fragment_journey"]
            assert journey["hops"] == 1 and journey["poisoned_hop"] is None
    assert signals >= {
        "silent_death", "injected_fault", "peer_without_evidence", "retry_storm",
        "bad_plan", "timeline_straggler", "slow_link", "poisoned_hop", "trace_error",
    }, signals


# ---------------------------------------------------------------------------
# selftest, exit codes, module entry
# ---------------------------------------------------------------------------


def test_selftest_and_exit_codes(tmp_path, capsys):
    assert tdiag.selftest(verbose=False)
    assert tdiag.main(["--selftest"]) == 0
    assert "selftest OK" in capsys.readouterr().out
    assert tdiag.main([]) == 2
    assert tdiag.main([str(tmp_path / "missing.jsonl")]) == 1
    assert tdiag.main(["--timeline", str(tmp_path / "nope.json")]) == 1
    assert "--timeline" in capsys.readouterr().err
    bad = tmp_path / "x.json"
    bad.write_text('{"not": "a timeline"}')
    with pytest.raises(ValueError):
        tdiag.load_timeline(str(bad))
    with pytest.raises(ValueError):
        tdiag.load_links(str(bad))


def test_module_entry_runs_without_jax():
    code = ("import sys, runpy; sys.argv = ['diagnose', '--selftest'];"
            "rc = 0\n"
            "try:\n runpy.run_module('torchft_tpu_torch.diagnose', run_name='__main__')\n"
            "except SystemExit as e:\n rc = e.code\n"
            "assert rc == 0, rc\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'torchft_tpu.'))"
            " or m == 'torchft_tpu']\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "selftest OK" in out.stdout


def test_every_phase_the_port_records_has_a_ledger_category():
    """The Manager's vocabulary and every literal ``_record_phase`` name in
    the port's sources map to a ledger category (no phase lands in the
    ``protocol`` default silently); the mapping is the JAX package's."""
    recorded = set(tmanager.PROTOCOL_PHASES)
    for path in (ROOT / "torchft_tpu_torch").rglob("*.py"):
        recorded |= set(re.findall(r'_record_phase\(\s*"([a-z_]+)"', path.read_text()))
    missing = recorded - set(tdiag.PHASE_CATEGORY)
    assert not missing, missing
    assert set(tdiag.PHASE_CATEGORY) == recorded
    assert set(tdiag.PHASE_CATEGORY.values()) <= set(tdiag.LEDGER_CATEGORIES)
    assert tdiag.PHASE_CATEGORY == jdiag.PHASE_CATEGORY
    assert tdiag.dominant_contributor({"quorum_rpc": 1.0, "ring": 5.0}) == "wire"
    assert tdiag.dominant_contributor({}) is None


# ---------------------------------------------------------------------------
# chaos smoke on port Managers (TestDiagnoseChaosSmoke's setting)
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_killed_port_replica_is_named_by_both_packages(tmp_path, monkeypatch, capsys):
    TOTAL, KILL_AT = 6, 2
    flight_file = tmp_path / "flight.jsonl"
    monkeypatch.setenv("TORCHFT_FLIGHT_FILE", str(flight_file))
    fr.RECORDER.clear()
    faults.FAULTS.configure(
        [FaultRule(site="train.step", replica="replica_1", step=KILL_AT)], seed=11)
    lighthouse = LighthouseServer(min_replicas=1, join_timeout_ms=100,
                                  heartbeat_timeout_ms=1000)
    # placeholders hold the first quorum open until both managers joined
    warm = LighthouseClient(lighthouse.address())
    warm.heartbeat("warm_a")
    warm.heartbeat("warm_b")
    warm.close()
    results, errors = {}, {}

    def run(rid):
        params = {"w": torch.zeros(4)}
        pg = ProcessGroupTCP(timeout=10.0)
        manager = Manager(
            pg=pg, min_replica_size=1,
            load_state_dict=lambda sd: params.update(w=sd["w"].clone()),
            state_dict=lambda: {"w": params["w"].clone()},
            lighthouse_addr=lighthouse.address(), replica_id=f"replica_{rid}",
            group_rank=0, group_world_size=1, use_async_quorum=False,
            timeout=20.0, quorum_timeout=20.0,
        )
        try:
            while manager.current_step() < TOTAL:
                step = manager.current_step()
                manager.start_quorum()
                faults.check("train.step", replica=f"replica_{rid}", step=step)
                grads = {"w": torch.full((4,), float(step + 1)) * (1.0 + 0.5 * rid)}
                avg = manager.allreduce(grads).wait(timeout=30)
                if manager.should_commit():
                    params["w"] = params["w"] - 0.1 * avg["w"]
            results[rid] = {"step": manager.current_step()}
        except InjectedFault:
            pg.abort()
            results[rid] = {"killed_at": manager.current_step()}
        except BaseException as e:  # noqa: BLE001 - reported below
            errors[rid] = e
        finally:
            manager.shutdown()

    threads = [threading.Thread(target=run, args=(r,), daemon=True) for r in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "replica hung"
    finally:
        faults.FAULTS.configure([])
        lighthouse.shutdown()
    assert not errors, errors
    assert results == {0: {"step": TOTAL}, 1: {"killed_at": KILL_AT}}

    argv = [str(flight_file)]
    want = _report(jdiag.main, argv, capsys)
    got = _report(tdiag.main, argv, capsys)
    assert got == want
    assert got["culprit"]["replica_id"].startswith("replica_1"), got["culprit"]
    assert got["failure"]["phase"] in ("allreduce", "manager.error", "abort")
