"""tft-torch-verify command line (tft-verify over the port): the
quorum-protocol model checker + the wire-schema lock workflow, which holds
torchft_tpu_torch/coordination.py to the native servers under native/.

Exit codes: 0 clean, 1 violation/drift found, 2 usage or selftest
failure.  Tier-1 pins the gates via tests/test_torch_verify.py and
tests/test_torch_wire_schema.py.

Typical invocations::

    tft-torch-verify                   # explore every scenario + mutation
                                       # gate + liveness schedules + drift
    tft-torch-verify --selftest        # fast internal-consistency gate
    tft-torch-verify --scenario churn  # one scenario, verbose stats
    tft-torch-verify --mutate heal_from_stale --dump cex.jsonl
                                       # seeded-bug counterexample as a
                                       # flight dump torchft-torch-diagnose
                                       # can render
    tft-torch-verify --write-lock      # regenerate analysis/protocol.lock
    tft-torch-verify --drift           # wire-schema drift findings only
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional, Sequence

from torchft_tpu_torch.analysis import model_checker as mc
from torchft_tpu_torch.analysis import plan_verify as pv
from torchft_tpu_torch.analysis import wire_schema as ws
from torchft_tpu_torch.analysis.core import SelftestError
from torchft_tpu_torch.analysis.protocol_model import MUTATIONS


def _detect_root(start: Optional[str] = None) -> str:
    """Walk up from ``start`` (default: cwd) to the tree that holds the
    native sources; fall back to the package's grandparent (the repo
    layout) and finally cwd."""
    candidates = [start or os.getcwd()]
    pkg_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    candidates.append(pkg_root)
    for cand in candidates:
        d = os.path.abspath(cand)
        while True:
            if os.path.isfile(os.path.join(d, "native", "lighthouse.cc")):
                return d
            parent = os.path.dirname(d)
            if parent == d:
                break
            d = parent
    return os.path.abspath(start or os.getcwd())


def _print_result(name: str, r: mc.CheckResult, verbose: bool) -> None:
    status = "ok" if r.ok else "VIOLATION"
    line = (
        f"{name:12s} {status:9s} states={r.states} "
        f"transitions={r.transitions} goals={r.goal_states}"
    )
    print(line)
    if not r.ok and r.violation is not None:
        v = r.violation
        print(f"  invariant {v.invariant} violated by {v.replica_id} "
              f"in phase {v.phase}: {v.message}")
        if verbose:
            for op, _i, rid, step, qid in r.trace:
                print(f"    {rid:14s} {op:12s} step={step} quorum_id={qid}")


def run_explore_all(verbose: bool = False) -> int:
    bad = 0
    t0 = time.monotonic()
    for name, cfg in mc.SCENARIOS.items():
        r = mc.explore(cfg)
        _print_result(name, r, verbose)
        bad += 0 if r.ok else 1
    r = mc.explore_votes()
    _print_result("votes", r, verbose)
    bad += 0 if r.ok else 1
    for name, rcfg in mc.RESIZE_SCENARIOS.items():
        r = mc.explore_resize(rcfg)
        _print_result(name, r, verbose)
        bad += 0 if r.ok else 1
    for name, ecfg in mc.ELECTION_SCENARIOS.items():
        r = mc.explore_election(ecfg)
        _print_result(name, r, verbose)
        bad += 0 if r.ok else 1
    for name, scfg in mc.RESTORE_SCENARIOS.items():
        r = mc.explore_restore(scfg)
        _print_result(name, r, verbose)
        bad += 0 if r.ok else 1
    print(f"explored clean in {time.monotonic() - t0:.1f}s"
          if not bad else f"{bad} scenario(s) violated")
    return 1 if bad else 0


def run_mutation_gate(verbose: bool = False) -> int:
    """Every seeded protocol bug must be caught by its expected invariant."""
    missed = 0
    for m in MUTATIONS:
        r = mc.check_mutation(m.name)
        caught = (not r.ok) and r.violation is not None and (
            r.violation.invariant == m.catches
        )
        mark = "caught" if caught else "MISSED"
        print(f"mutation {m.name:26s} {mark} "
              f"(expect {m.catches}, "
              f"got {r.violation.invariant if r.violation else 'clean'})")
        if not caught:
            missed += 1
        elif verbose:
            _print_result(m.name, r, verbose=True)
    return 1 if missed else 0


def run_plan_gate(verbose: bool = False) -> int:
    """The tft-plan scenario: exhaustive small-world plan
    enumeration on all three planes must verify clean, and every seeded
    plan mutation must be caught by its named invariant."""
    bad = 0
    t0 = time.monotonic()
    r = pv.explore_plans()
    violations = r["violations"]
    print(f"{'plan':12s} {'ok' if not violations else 'VIOLATION':9s} "
          f"plans={r['plans']} invariants={len(pv.INVARIANTS)} "
          f"({time.monotonic() - t0:.1f}s)")
    if violations:
        bad += 1
        for v in violations[: 20 if verbose else 5]:
            print(f"  invariant {v.invariant} violated at {v.subject}: "
                  f"{v.message}")
    for m in pv.PLAN_MUTATIONS:
        vs = pv.check_plan_mutation(m.name)
        got = vs[0].invariant if vs else "clean"
        caught = got == m.catches
        print(f"plan mutation {m.name:18s} "
              f"{'caught' if caught else 'MISSED'} "
              f"(expect {m.catches}, got {got})")
        if not caught:
            bad += 1
        elif verbose:
            for v in vs[:3]:
                print(f"    {v.invariant}: {v.message}")
    return 1 if bad else 0


def run_liveness(verbose: bool = False) -> int:
    stuck = 0
    for name, scenario, rotation in mc.LIVENESS_SCHEDULES:
        ok, used, trace = mc.run_schedule(mc.SCENARIOS[scenario], rotation)
        print(f"schedule {name:12s} {'ok' if ok else 'LIVELOCK'} "
              f"({used} transitions)")
        if not ok:
            stuck += 1
            if verbose:
                for op, _i, rid, step, qid in trace[-20:]:
                    print(f"    {rid:14s} {op:12s} step={step} "
                          f"quorum_id={qid}")
    return 1 if stuck else 0


def run_drift(root: str) -> int:
    (
        py_source,
        native_sources,
        native_file_of,
        docs_text,
        lock,
        lock_file,
    ) = ws.gather_inputs(root)
    if not native_sources:
        print(f"tft-verify: no native sources under {root} "
              f"(pass --root)", file=sys.stderr)
        return 2
    found = list(
        ws.run_checks(
            py_source,
            native_sources,
            docs_text,
            lock,
            native_file_of=native_file_of,
            lock_file=lock_file,
        )
    )
    for f in found:
        print(f.render())
    print(f"wire drift: {len(found)} finding(s)")
    return 1 if found else 0


def write_lock(root: str) -> int:
    (
        py_source,
        native_sources,
        _nf,
        _docs,
        _lock,
        lock_file,
    ) = ws.gather_inputs(root)
    if not native_sources:
        print(f"tft-verify: no native sources under {root} "
              f"(pass --root)", file=sys.stderr)
        return 2
    fresh = ws.build_lock(py_source, native_sources)
    # write where gather_inputs read: the one canonical lock location
    path = os.path.join(root, lock_file)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(ws.dump_lock(fresh))
    print(f"wrote {path}")
    return 0


def run_selftest() -> int:
    """Fast internal-consistency gate: the checker catches every seeded
    mutation, the steady scenario is clean, and the wire extractor's own
    selftest passes."""
    rc = run_mutation_gate()
    r = mc.explore(mc.SCENARIOS["steady"])
    _print_result("steady", r, verbose=False)
    if not r.ok:
        rc = 2
    try:
        ws.selftest()
        print("selftest wire-drift: ok")
    except SelftestError as e:
        print(f"selftest wire-drift: FAIL — {e}", file=sys.stderr)
        rc = 2
    missed_plan = sum(
        1
        for m in pv.PLAN_MUTATIONS
        if (lambda vs: not vs or vs[0].invariant != m.catches)(
            pv.check_plan_mutation(m.name)
        )
    )
    print(f"selftest plan mutations: "
          f"{'ok' if not missed_plan else f'{missed_plan} MISSED'}")
    if missed_plan:
        rc = 2
    return 2 if rc else 0


def main(argv: "Optional[Sequence[str]]" = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tft-torch-verify",
        description=(
            "quorum-protocol model checker (bounded exhaustive exploration "
            "+ mutation gate + liveness schedules) and wire-schema lock "
            "workflow.  See docs/static_analysis.md."
        ),
    )
    parser.add_argument("--selftest", action="store_true",
                        help="fast internal-consistency gate and exit")
    parser.add_argument("--scenario", metavar="NAME",
                        help="explore one scenario (see --list)")
    parser.add_argument("--mutate", metavar="NAME",
                        help="run the checker over one seeded protocol bug")
    parser.add_argument("--dump", metavar="PATH",
                        help="with --mutate: write the counterexample as a "
                        "flight-recorder JSONL dump for torchft-torch-diagnose")
    parser.add_argument("--list", action="store_true",
                        help="list scenarios, mutations and schedules")
    parser.add_argument("--drift", action="store_true",
                        help="run only the wire-schema drift checks")
    parser.add_argument("--write-lock", action="store_true",
                        help="regenerate torchft_tpu_torch/analysis/protocol.lock")
    parser.add_argument("--root", default=None,
                        help="repo root for --drift/--write-lock "
                        "(default: auto-detect)")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="print counterexample traces")
    args = parser.parse_args(argv)

    if args.list:
        for name, cfg in mc.SCENARIOS.items():
            print(f"scenario {name:12s} {cfg}")
        for name, rcfg in mc.RESIZE_SCENARIOS.items():
            print(f"scenario {name:12s} {rcfg}")
        for name, ecfg in mc.ELECTION_SCENARIOS.items():
            print(f"scenario {name:12s} {ecfg}")
        for name, scfg in mc.RESTORE_SCENARIOS.items():
            print(f"scenario {name:12s} {scfg}")
        print(f"scenario {'plan':12s} topology-plan IR enumeration + "
              f"mutation gate (reduction/serving/stripe)")
        for m in MUTATIONS:
            print(f"mutation {m.name:26s} -> {m.catches}: {m.doc}")
        for pm in pv.PLAN_MUTATIONS:
            print(f"plan mutation {pm.name:21s} -> {pm.catches}: {pm.doc}")
        for name, scenario, rotation in mc.LIVENESS_SCHEDULES:
            print(f"schedule {name:12s} scenario={scenario} "
                  f"rotation={rotation}")
        return 0
    if args.selftest:
        return run_selftest()
    if args.write_lock:
        return write_lock(_detect_root(args.root))
    if args.drift:
        return run_drift(_detect_root(args.root))
    if args.mutate:
        if args.mutate not in {m.name for m in MUTATIONS}:
            print(f"tft-verify: unknown mutation {args.mutate!r}",
                  file=sys.stderr)
            return 2
        r = mc.check_mutation(args.mutate)
        _print_result(args.mutate, r, args.verbose)
        if args.dump and not r.ok:
            mc.write_flight_dump(r, args.dump)
            print(f"wrote counterexample dump to {args.dump} "
                  f"(render: torchft-torch-diagnose {args.dump})")
        return 1 if not r.ok else 0
    if args.scenario:
        if args.scenario == "plan":
            return run_plan_gate(args.verbose)
        if args.scenario in mc.RESIZE_SCENARIOS:
            r = mc.explore_resize(mc.RESIZE_SCENARIOS[args.scenario])
            _print_result(args.scenario, r, args.verbose)
            return 0 if r.ok else 1
        if args.scenario in mc.ELECTION_SCENARIOS:
            r = mc.explore_election(mc.ELECTION_SCENARIOS[args.scenario])
            _print_result(args.scenario, r, args.verbose)
            return 0 if r.ok else 1
        if args.scenario in mc.RESTORE_SCENARIOS:
            r = mc.explore_restore(mc.RESTORE_SCENARIOS[args.scenario])
            _print_result(args.scenario, r, args.verbose)
            return 0 if r.ok else 1
        if args.scenario not in mc.SCENARIOS:
            print(f"tft-verify: unknown scenario {args.scenario!r} "
                  f"(see --list)", file=sys.stderr)
            return 2
        r = mc.explore(mc.SCENARIOS[args.scenario])
        _print_result(args.scenario, r, args.verbose)
        return 0 if r.ok else 1

    # the full gate: exploration + mutations + liveness + plans + drift
    rc = run_explore_all(args.verbose)
    rc = run_mutation_gate(args.verbose) or rc
    rc = run_liveness(args.verbose) or rc
    rc = run_plan_gate(args.verbose) or rc
    rc = run_drift(_detect_root(args.root)) or rc
    return rc


if __name__ == "__main__":
    sys.exit(main())
