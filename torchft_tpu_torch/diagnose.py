"""torchft-torch-diagnose: cross-replica post-mortem from flight dumps + events.

PyTorch port of ``torchft_tpu/diagnose.py``: the same readers, analyses,
renderers and CLI, over the files the port writes.  The report on the same
input files is the JAX package's report, key for key
(tests/test_torch_diagnose.py), but for one repair: the trace ledger's
``dominant_overall`` breaks a tie between categories deterministically
(:func:`analyze_trace`), where the JAX package's choice follows the
interpreter's string hash seed.  The analysis reads no clock (``time``
only stamps the selftest's synthetic dumps).

``python -m torchft_tpu_torch.diagnose dump1.jsonl dump2.jsonl [--events ev.jsonl]``
merges N replicas' flight-recorder dumps (``TORCHFT_FLIGHT_FILE``,
utils/flightrecorder.py) and structured-event logs
(``TORCHFT_EVENTS_FILE``, utils/logging.py) into **one cross-replica
timeline keyed by (step, quorum_id)**, then flags the likely culprit of a
degraded run:

1. **injected faults** — a chaos-killed replica carries a fault-tagged
   flight record (``utils/faults.py`` stamps every injection);
2. **silent death** — the replica whose records stop earliest while its
   peers kept going (the classic "which replica stalled the quorum"
   question both PCCL-style reports treat as first-class);
3. **last to enter the failed phase** — among replicas that DID reach the
   step where the first error fired, the one missing (or last to enter)
   that phase;
4. **retry storms** — bursts of ``retry`` records flagged per operation.

``--timeline <file-or-URL>`` additionally folds in the lighthouse's
rolling cluster step-timeline (``GET /timeline.json`` — aggregated from
the heartbeat-piggybacked per-replica step digests) so one scrape
answers "what was the whole fleet doing at step N"; its worst-K
straggler snapshot names a culprit (signal ``timeline_straggler``) even
when no flight dumps were collected at all.

``--links <file-or-URL>`` folds in the lighthouse's fleet link-state
matrix (``GET /links.json`` — aggregated from the heartbeat-piggybacked
per-host link digests, utils/linkstats.py) and adds a ``slow_link``
culprit signal: a host pair whose sustained goodput is a strong outlier
below the fleet median names the wire itself as the culprit — the one
degradation mode no per-replica evidence can see (every replica on the
slow link looks equally unlucky from inside).  Combined with ``--trace``
it also splits the critical-path ledger's ``wire`` category into
**expected** (what the fleet-median link would have spent moving the
same traffic) vs **excess** (the slow link's surcharge), so "wire ate
the step" becomes "the wire was 4x slower than the fleet's, costing
120ms/step".

``--fragment <frag_id>`` (e.g. ``weights/0``) reconstructs one
fragment's whole journey — publish, relay hops, serving clients, heal
destinations, durable store — from the ``fragment.hold`` /
``fragment.hop`` provenance records in the given dumps.  The provenance
registry (checkpointing/provenance.py) dumps its hop ring to
``TORCHFT_FLIGHT_FILE + ".prov"`` alongside every flight dump (same
JSONL format, so ``.prov`` files are passed as ordinary positional
dumps).  The first hop whose digest verdict is ``mismatch``/``torn`` is
where bad bytes entered the plane; its source is named as the
``poisoned_hop`` culprit — attribution from serialized dumps alone, no
live fleet required.

``--trace <TORCHFT_TRACE_FILE>`` reads the distributed-tracing span sink
(utils/tracing.py) and reconstructs the **cross-replica critical path**
per step: trace ids are deterministic per step, every replica's
``quorum_round`` root plus its phase / native ``rpc.*`` / heal /
quantized-pipeline children land in one trace, and the ledger attributes
the slowest replica's wall time to ``compute`` / ``codec`` / ``wire`` /
``protocol`` / ``straggler-wait`` — naming the dominant contributor per
step and per replica, and (signal ``trace_error``) the replica whose
span failed, from the trace file alone.  All three inputs join on
``step``/``quorum_id``, so dumps + timeline + trace compose into one
report.

Output is a human timeline + verdict (default) or ``--json`` for machines.
``--selftest`` generates a synthetic two-replica dump pair in a temp dir
and checks culprit attribution end to end — wired into the test suite so
the CLI can never silently rot (tests/test_torch_diagnose.py).

Exit codes: 0 = analysis produced (or selftest passed), 1 = selftest
failed / no input parseable, 2 = bad usage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "load_records",
    "load_timeline",
    "load_links",
    "load_spans",
    "analyze",
    "analyze_timeline",
    "analyze_links",
    "analyze_fragment",
    "analyze_trace",
    "apply_wire_split",
    "ledger_categories",
    "dominant_contributor",
    "render_text",
    "render_timeline_text",
    "render_links_text",
    "render_fragment_text",
    "render_trace_text",
    "selftest",
    "main",
]

# record statuses that mean "something went wrong here"
_ERROR_STATUSES = ("error", "abort")
# event kinds that mean the same in the TORCHFT_EVENTS_FILE stream
_ERROR_KINDS = ("error", "abort")
# at least this many retry records for one op counts as a storm
RETRY_STORM_THRESHOLD = 3
# a straggler score this far past typical (~1.0) in the lighthouse
# timeline snapshot is a culprit signal of its own
TIMELINE_STRAGGLER_SCORE = 4.0
# a WAN link whose goodput is this many times below the fleet median is
# a slow_link culprit (with enough samples to call it sustained)
SLOW_LINK_RATIO = 4.0
# estimator samples required before a link can be named a culprit — a
# couple of unlucky transfers are noise, not a slow wire
SLOW_LINK_MIN_SAMPLES = 8

#: protocol-phase name -> critical-path ledger cost category: one entry
#: for every phase the port's Manager records (``manager.PROTOCOL_PHASES``;
#: the Baby process group's stats are its own, never phases), the JAX
#: package's mapping unchanged, so both packages' ledgers speak one
#: vocabulary.
PHASE_CATEGORY = {
    "quorum_wait": "straggler-wait",
    "quorum_rpc": "protocol",
    "pg_configure": "protocol",
    "commit": "protocol",
    "host_sync": "compute",
    "ring": "wire",
    "heal_send": "wire",
    "heal_recv": "wire",
    # striped-heal receive split (ISSUE 15): the manifest fetch is a
    # protocol round trip, the digest diff and fragment decode are codec
    # work, the striped fragment fetches are wire
    "heal_manifest": "protocol",
    "heal_diff": "codec",
    "heal_wire": "wire",
    "heal_decode": "codec",
    # online parallelism switching (parallel/layout.py): the reshard
    # slice-diff transfers are wire cost; the commit round is protocol
    "reshard": "wire",
    "layout_commit": "protocol",
}

#: the ledger's full category vocabulary, in render order
LEDGER_CATEGORIES = ("compute", "codec", "wire", "protocol", "straggler-wait")


def ledger_categories(phase_times: "Dict[str, Any]") -> "Dict[str, float]":
    """Fold a phase->duration mapping (``Manager.phase_times`` deltas, or
    a timeline bucket's ``phase_ms``) into ledger categories.  Unknown
    phase names count as ``protocol`` (they are protocol bookkeeping by
    construction — every traced phase is in ``manager.PROTOCOL_PHASES``)."""
    out: "Dict[str, float]" = {}
    for name, dur in phase_times.items():
        try:
            v = float(dur)
        except (TypeError, ValueError):
            continue
        cat = PHASE_CATEGORY.get(name, "protocol")
        out[cat] = out.get(cat, 0.0) + v
    return out


def dominant_contributor(phase_times: "Dict[str, Any]") -> "Optional[str]":
    """The ledger category that ate the most time, or None on empty/zero
    input — the one-word answer bench legs and the per-step ledger give."""
    cats = ledger_categories(phase_times)
    if not cats or max(cats.values()) <= 0.0:
        return None
    return max(cats.items(), key=lambda kv: kv[1])[0]


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def _normalize_flight(rec: "Dict[str, Any]") -> "Dict[str, Any]":
    """One flight record -> timeline entry."""
    return {
        "source": "flight",
        "t_ns": int(rec.get("end_ns") or rec.get("start_ns") or 0),
        "start_ns": int(rec.get("start_ns") or 0),
        "replica_id": str(rec.get("replica_id", "") or ""),
        "op": str(rec.get("op", "?")),
        "status": str(rec.get("status", "ok")),
        "step": rec.get("step"),
        "quorum_id": rec.get("quorum_id"),
        "fields": {
            k: v
            for k, v in rec.items()
            if k
            not in ("flight", "op", "status", "start_ns", "end_ns", "replica_id",
                    "step", "quorum_id")
        },
    }


def _normalize_event(ev: "Dict[str, Any]") -> "Dict[str, Any]":
    """One structured event (utils/logging.py JSONL) -> timeline entry."""
    return {
        "source": "event",
        "t_ns": int(float(ev.get("ts", 0.0)) * 1e9),
        "start_ns": int(float(ev.get("ts", 0.0)) * 1e9),
        "replica_id": str(ev.get("replica_id", "") or ""),
        "op": str(ev.get("kind", "?")),
        "status": "error" if ev.get("kind") in _ERROR_KINDS else "ok",
        "step": ev.get("step"),
        "quorum_id": ev.get("quorum_id"),
        "fields": {
            k: v
            for k, v in ev.items()
            if k not in ("ts", "kind", "replica_id", "step", "quorum_id")
        },
    }


def load_records(
    paths: "List[str]", event_paths: "Optional[List[str]]" = None
) -> "Tuple[List[Dict[str, Any]], List[str]]":
    """Parse dump + event JSONL files into deduplicated timeline entries.

    A flight file accumulates one full ring snapshot per dump trigger, so
    the same record can appear many times across (and within) files —
    dedupe on (replica_id, op, start_ns, status).  Returns (entries sorted
    by time, warnings)."""
    entries: "List[Dict[str, Any]]" = []
    warnings: "List[str]" = []
    seen: set = set()

    def add(entry: "Dict[str, Any]") -> None:
        key = (
            entry["replica_id"], entry["op"], entry["start_ns"],
            entry["status"], entry["source"],
        )
        if key in seen:
            return
        seen.add(key)
        entries.append(entry)

    def parse_file(path: str, events_only: bool) -> None:
        try:
            fh = open(path, "r", encoding="utf-8")
        except OSError as e:
            warnings.append(f"{path}: unreadable ({e})")
            return
        bad = 0
        with fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    bad += 1
                    continue
                if not isinstance(obj, dict):
                    bad += 1
                    continue
                if obj.get("flight") == "meta":
                    continue  # dump headers are bookkeeping, not evidence
                if obj.get("flight") == "rec" and not events_only:
                    add(_normalize_flight(obj))
                elif "kind" in obj:
                    add(_normalize_event(obj))
                else:
                    bad += 1
        if bad:
            warnings.append(f"{path}: skipped {bad} unparseable line(s)")

    for p in paths:
        parse_file(p, events_only=False)
    for p in event_paths or []:
        parse_file(p, events_only=True)
    entries.sort(key=lambda e: e["t_ns"])
    return entries, warnings


def load_timeline(src: str) -> "Dict[str, Any]":
    """Load a lighthouse ``/timeline.json`` document from a file path or
    an ``http(s)://`` URL (``host:port`` shorthand fetches
    ``http://host:port/timeline.json``; a ``h1:p,h2:p`` comma list rides
    the coordination-plane-HA failover walk to whichever peer currently
    leads).  Raises on unreadable/invalid input — a requested timeline
    that cannot be read is an error, not a silently thinner report."""
    if "," in src and ":" in src and not os.path.exists(src):
        # replicated-lighthouse endpoint list: the RPC client walks dead
        # peers and follows NOT_LEADER redirects (coordination.py)
        from torchft_tpu_torch.coordination import LighthouseClient

        client = LighthouseClient(src)
        try:
            doc = client.timeline(timeout=10.0)
        finally:
            client.close()
        if not isinstance(doc, dict) or "steps" not in doc:
            raise ValueError(f"{src}: not a /timeline.json document")
        return doc
    if src.startswith(("http://", "https://")) or (
        "/" not in src and ":" in src and not os.path.exists(src)
    ):
        import urllib.request

        url = src if src.startswith("http") else f"http://{src}"
        if not url.rstrip("/").endswith("/timeline.json"):
            url = url.rstrip("/") + "/timeline.json"
        with urllib.request.urlopen(url, timeout=10) as resp:
            doc = json.loads(resp.read().decode())
    else:
        with open(src, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    if not isinstance(doc, dict) or "steps" not in doc:
        raise ValueError(f"{src}: not a /timeline.json document")
    return doc


def load_links(src: str) -> "Dict[str, Any]":
    """Load a lighthouse ``/links.json`` document from a file path, an
    ``http(s)://`` URL, a ``host:port`` shorthand, or a replicated-
    lighthouse ``h1:p,h2:p`` comma list (which rides the HA failover walk
    via the ``links`` RPC).  Raises on unreadable/invalid input, same
    contract as :func:`load_timeline`."""
    if "," in src and ":" in src and not os.path.exists(src):
        from torchft_tpu_torch.coordination import LighthouseClient

        client = LighthouseClient(src)
        try:
            doc = client.links(timeout=10.0)
        finally:
            client.close()
        if not isinstance(doc, dict) or "rows" not in doc:
            raise ValueError(f"{src}: not a /links.json document")
        return doc
    if src.startswith(("http://", "https://")) or (
        "/" not in src and ":" in src and not os.path.exists(src)
    ):
        import urllib.request

        url = src if src.startswith("http") else f"http://{src}"
        if not url.rstrip("/").endswith("/links.json"):
            url = url.rstrip("/") + "/links.json"
        with urllib.request.urlopen(url, timeout=10) as resp:
            doc = json.loads(resp.read().decode())
    else:
        with open(src, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    if not isinstance(doc, dict) or "rows" not in doc:
        raise ValueError(f"{src}: not a /links.json document")
    return doc


def load_spans(path: str) -> "Tuple[List[Dict[str, Any]], List[str]]":
    """Parse a ``TORCHFT_TRACE_FILE`` JSONL span sink.  Returns (spans,
    warnings); a span is any object with ``trace_id``/``span_id``/``name``
    (the exact schema ``Tracer.export_span`` writes)."""
    spans: "List[Dict[str, Any]]" = []
    warnings: "List[str]" = []
    try:
        fh = open(path, "r", encoding="utf-8")
    except OSError as e:
        return [], [f"{path}: unreadable ({e})"]
    bad = 0
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                bad += 1
                continue
            if (
                isinstance(obj, dict)
                and "trace_id" in obj
                and "span_id" in obj
                and "name" in obj
            ):
                spans.append(obj)
            else:
                bad += 1
    if bad:
        warnings.append(f"{path}: skipped {bad} non-span line(s)")
    return spans, warnings


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------


def analyze(entries: "List[Dict[str, Any]]") -> "Dict[str, Any]":
    """Cross-replica culprit attribution over a merged timeline."""
    # Backfill steps per replica: PG-level records (collectives, aborts)
    # carry no step — the worker thread doesn't know it — but the same
    # replica's quorum phases do, so inherit the latest preceding one.
    # This is what lets "who entered the failed phase at step N" work.
    last_step: "Dict[str, int]" = {}
    for e in entries:  # time-sorted by load_records
        rid = e["replica_id"]
        if isinstance(e.get("step"), int):
            last_step[rid] = e["step"]
        elif rid in last_step:
            e["step"] = last_step[rid]
            e["step_inferred"] = True

    replicas: "Dict[str, Dict[str, Any]]" = {}
    for e in entries:
        rid = e["replica_id"]
        if not rid:
            continue
        if e["op"] == "fault" or e["status"] == "fault":
            # Fault records are stamped with the BARE replica id (no
            # ":uuid" incarnation suffix) — folding them into the
            # liveness table would mint a phantom replica whose records
            # "stop" at the injection and shadow the real incarnation.
            # The injected_fault branch handles them prefix-aware.
            continue
        info = replicas.setdefault(
            rid, {"first_ns": e["t_ns"], "last_ns": e["t_ns"], "max_step": -1,
                  "records": 0, "errors": 0}
        )
        info["records"] += 1
        info["last_ns"] = max(info["last_ns"], e["t_ns"])
        info["first_ns"] = min(info["first_ns"], e["t_ns"])
        if isinstance(e.get("step"), int):
            info["max_step"] = max(info["max_step"], e["step"])
        if e["status"] in _ERROR_STATUSES:
            info["errors"] += 1

    faults = [
        e for e in entries
        if e["op"] == "fault" or e["status"] == "fault"
        or (e["source"] == "event" and e["op"] == "fault")
    ]
    errors = [e for e in entries if e["status"] in _ERROR_STATUSES]

    # retry storms: many retries of one op is a failure signature of its own
    retry_counts: "Dict[Tuple[str, str], int]" = defaultdict(int)
    for e in entries:
        if e["op"] == "retry":
            retry_counts[(e["replica_id"], str(e["fields"].get("retry_op", "?")))] += 1
    storms = [
        {"replica_id": rid, "op": op, "retries": n}
        for (rid, op), n in sorted(retry_counts.items())
        if n >= RETRY_STORM_THRESHOLD
    ]

    # The failure point: the FIRST hard error in the merged timeline —
    # later errors are usually cascade.  Deliberate aborts (status
    # "abort": teardown, watchdogs, a dying replica closing its own PG)
    # only qualify when no hard error exists.
    failure: "Optional[Dict[str, Any]]" = None
    if errors:
        hard = [e for e in errors if e["status"] == "error"]
        first = (hard or errors)[0]
        step = first.get("step")
        quorum_id = first.get("quorum_id")
        if step is None:
            # PG-level records carry no step (the worker thread doesn't
            # know it); backfill from the reporter's nearest earlier
            # record that does — e.g. its quorum phases for that round.
            for e in reversed(entries):
                if (
                    e["t_ns"] <= first["t_ns"]
                    and e["replica_id"] == first["replica_id"]
                    and isinstance(e.get("step"), int)
                ):
                    step = e["step"]
                    if quorum_id is None:
                        quorum_id = e.get("quorum_id")
                    break
        failure = {
            "phase": first["op"],
            "step": step,
            "quorum_id": quorum_id,
            "t_ns": first["t_ns"],
            "reported_by": first["replica_id"],
            "detail": first["fields"].get("reason")
            or first["fields"].get("error")
            or first["fields"].get("message", ""),
        }

    culprit: "Optional[Dict[str, Any]]" = None
    # 1) injected fault wins — but only when the chaos layer stamped a
    #    REPLICA and that replica actually stopped.  A fault the system
    #    recovered from (a retried heal, an absorbed connection drop) or
    #    one without replica context (transports supply step only) is
    #    context, not the culprit — blaming it would mask a later real
    #    death.
    kill_faults = [
        f for f in faults
        if f["replica_id"]
        and str(
            f["fields"].get("action", f["fields"].get("fault", ""))
        ).find("delay") < 0
    ]
    if kill_faults and replicas:
        # Prefix-aware: the faults layer stamps the BARE replica id while
        # protocol records carry the ":uuid" incarnation suffix — compare
        # per logical replica, and report the full incarnation id.
        def _base(rid: str) -> str:
            return rid.split(":", 1)[0]

        last_by_base: "Dict[str, Tuple[int, str]]" = {}
        for rid, info in replicas.items():
            b = _base(rid)
            if b not in last_by_base or info["last_ns"] > last_by_base[b][0]:
                last_by_base[b] = (info["last_ns"], rid)
        global_last = max(info["last_ns"] for info in replicas.values())
        for f in reversed(kill_faults):
            fb = _base(f["replica_id"])
            my_last, full_id = last_by_base.get(fb, (0, f["replica_id"]))
            dead = (global_last - my_last) / 1e9 > 0.05
            if dead or len(last_by_base) == 1:
                culprit = {
                    "replica_id": full_id,
                    "reason": (
                        f"injected fault "
                        f"{f['fields'].get('fault') or f['fields'].get('site', '?')}"
                        f" at step {f.get('step')}"
                    ),
                    "signal": "injected_fault",
                }
                break
    # 1b) rejected live plan: a ``plan.verify`` record with a reject
    #     verdict (TORCHFT_PLAN_VERIFY) names the exact invariant a
    #     synthesized topology plan violated at its commit point — far
    #     more specific than any death/straggler inference, so it
    #     outranks everything except an injected fault.
    if culprit is None:
        for e in reversed(entries):
            if e["op"] != "plan.verify":
                continue
            if e["fields"].get("verdict") != "reject":
                continue
            culprit = {
                "replica_id": e["replica_id"] or "(unknown)",
                "reason": (
                    f"rejected live {e['fields'].get('plane', '?')} plan "
                    f"(epoch {e.get('step')}): invariant "
                    f"{e['fields'].get('invariant', '?')} violated — "
                    f"{e['fields'].get('detail', '')}"
                ),
                "signal": "bad_plan",
            }
            break
    # 2) silent death: a replica whose records stop earliest while peers
    #    kept producing evidence afterwards.  Only with a failure
    #    signature on the table — staggered shutdown of a HEALTHY run
    #    also leaves unequal last-record times, and a post-mortem tool
    #    that names culprits on clean runs trains operators to ignore it.
    if (
        culprit is None
        and len(replicas) >= 2
        and (failure is not None or kill_faults)
    ):
        by_last = sorted(replicas.items(), key=lambda kv: kv[1]["last_ns"])
        (dead_id, dead), (_, next_one) = by_last[0], by_last[1]
        gap_s = (next_one["last_ns"] - dead["last_ns"]) / 1e9
        if gap_s > 0.05:
            culprit = {
                "replica_id": dead_id,
                "reason": (
                    f"records stop at step {dead['max_step']} "
                    f"({gap_s:.2f}s before the next replica's last record)"
                    + (
                        f"; peers failed in phase {failure['phase']} after"
                        if failure is not None
                        else ""
                    )
                ),
                "signal": "silent_death",
            }
    # 3) last to enter the failed phase: among replicas with records at
    #    the failure step, the one that never entered (or entered last).
    if culprit is None and failure is not None and failure.get("step") is not None:
        step = failure["step"]
        entered: "Dict[str, int]" = {}
        for e in entries:
            if e.get("step") == step and e["op"] == failure["phase"] and e["replica_id"]:
                entered.setdefault(e["replica_id"], e["start_ns"])
        # Prefix-aware: fault records use the bare replica id while
        # protocol records use the ":uuid" incarnation id — a logical
        # replica whose incarnation entered is not missing.
        entered_bases = {rid.split(":", 1)[0] for rid in entered}
        missing = [
            rid
            for rid in replicas
            if rid not in entered
            and rid.split(":", 1)[0] not in entered_bases
        ]
        # earliest-stopped first (most suspicious); among same-base ids
        # report the full incarnation id
        missing.sort(key=lambda r: replicas[r]["last_ns"])
        if missing:
            base0 = missing[0].split(":", 1)[0]
            candidates = [
                r for r in missing if r.split(":", 1)[0] == base0
            ]
            culprit = {
                "replica_id": max(candidates, key=len),
                "reason": (
                    f"never entered failed phase {failure['phase']} "
                    f"at step {step}"
                ),
                "signal": "missing_phase",
            }
        elif len(entered) >= 2:
            # Only meaningful with peers to compare against: with a single
            # entrant (e.g. only the survivor's dump was collected) this
            # would confidently blame the replica that REPORTED the
            # failure.
            last_rid = max(entered, key=lambda r: entered[r])
            culprit = {
                "replica_id": last_rid,
                "reason": (
                    f"last replica to enter failed phase "
                    f"{failure['phase']} at step {step}"
                ),
                "signal": "last_entry",
            }
    # 3b) one-sided evidence: only the reporter's records exist (the peer
    #     was SIGKILLed/OOM-killed and never dumped) but its failure names
    #     a peer rank — point at that peer rather than staying silent or
    #     blaming the survivor.
    if culprit is None and failure is not None and len(replicas) == 1:
        fail_fields = next(
            (
                e["fields"]
                for e in entries
                if e["t_ns"] == failure["t_ns"]
                and e["status"] in _ERROR_STATUSES
            ),
            {},
        )
        peer = fail_fields.get("recv_peer", fail_fields.get("send_peer"))
        if peer is not None:
            culprit = {
                "replica_id": f"replica rank {peer} (no records collected)",
                "reason": (
                    f"{failure['reported_by']} failed in "
                    f"{failure['phase']} talking to rank {peer}; that peer "
                    f"left no flight records (killed without a dump?)"
                ),
                "signal": "peer_without_evidence",
            }
    # 4) retry storms as a last resort.
    if culprit is None and storms:
        worst = max(storms, key=lambda s: s["retries"])
        culprit = {
            "replica_id": worst["replica_id"] or "(unknown)",
            "reason": f"retry storm: {worst['retries']}x {worst['op']}",
            "signal": "retry_storm",
        }

    return {
        "replicas": replicas,
        "failure": failure,
        "culprit": culprit,
        "faults": [
            {
                "replica_id": f["replica_id"],
                "step": f.get("step"),
                "fault": f["fields"].get("fault")
                or f"{f['fields'].get('site', '?')}:{f['fields'].get('action', '?')}",
                "t_ns": f["t_ns"],
            }
            for f in faults
        ],
        "retry_storms": storms,
        "entries": len(entries),
    }


def analyze_timeline(timeline: "Dict[str, Any]") -> "Dict[str, Any]":
    """Culprit attribution from the lighthouse's own fleet view: the
    worst straggler snapshot riding ``/timeline.json``.

    A replica is named when it is **stale** (still tracked, heartbeat
    expired — dead or wedged hard) or its straggler score is past
    ``TIMELINE_STRAGGLER_SCORE`` (progress age many multiples of the
    fleet-typical cadence).  This is evidence the flight-recorder path
    cannot see: it requires no dump from any replica."""
    worst = timeline.get("stragglers_worst") or []
    culprit: "Optional[Dict[str, Any]]" = None
    for row in worst:
        score = float(row.get("straggler_score") or 0.0)
        stale = bool(row.get("stale"))
        if stale or score >= TIMELINE_STRAGGLER_SCORE:
            reason = (
                f"lighthouse timeline: heartbeat stale at step "
                f"{row.get('step')} (lag {row.get('step_lag')})"
                if stale
                else (
                    f"lighthouse timeline: straggler score {score:.1f} "
                    f"(>= {TIMELINE_STRAGGLER_SCORE:.0f}x typical progress "
                    f"age) at step {row.get('step')}, "
                    f"lag {row.get('step_lag')}"
                )
            )
            culprit = {
                "replica_id": str(row.get("replica_id", "?")),
                "reason": reason,
                "signal": "timeline_straggler",
            }
            break  # worst-first order: the first hit is the worst
    steps = timeline.get("steps") or []
    return {
        "culprit": culprit,
        "steps": len(steps),
        "stragglers_worst": worst,
        "last_step": steps[-1].get("step") if steps else None,
    }


def _median(vals: "List[float]") -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0


def analyze_links(links: "Dict[str, Any]") -> "Dict[str, Any]":
    """The ``slow_link`` culprit signal from the fleet link matrix.

    Only **WAN rows** (``local=false``) compete — the intra-host fabric
    runs at memory speed and would drag the median up until every real
    wire looks like a culprit.  A link is named when its estimated
    goodput is ``SLOW_LINK_RATIO``x below the fleet-median WAN goodput
    with at least ``SLOW_LINK_MIN_SAMPLES`` samples behind the estimate
    (sustained, not one unlucky transfer).  The culprit is the host
    PAIR, not a replica: every replica crossing that wire is equally
    slow from inside, which is exactly why no flight dump can see it."""
    rows = [r for r in (links.get("rows") or []) if isinstance(r, dict)]
    wan = [
        r
        for r in rows
        if not r.get("local")
        and float(r.get("goodput_bps") or 0.0) > 0.0
    ]
    med = _median([float(r["goodput_bps"]) for r in wan])
    culprit: "Optional[Dict[str, Any]]" = None
    slow: "List[Dict[str, Any]]" = []
    for r in sorted(wan, key=lambda r: float(r["goodput_bps"])):
        g = float(r["goodput_bps"])
        if (
            med > 0.0
            and g * SLOW_LINK_RATIO < med
            and int(r.get("samples") or 0) >= SLOW_LINK_MIN_SAMPLES
        ):
            slow.append(r)
    if slow:
        r = slow[0]  # sorted ascending: the slowest sustained outlier
        culprit = {
            "replica_id": f"link {r.get('src')}->{r.get('peer')}",
            "reason": (
                f"link-state matrix: {r.get('plane')} goodput "
                f"{float(r['goodput_bps']) / 1e6:.1f} MB/s is "
                f"{med / max(float(r['goodput_bps']), 1e-9):.1f}x below "
                f"the fleet-median WAN link ({med / 1e6:.1f} MB/s, "
                f"{r.get('samples')} samples)"
            ),
            "signal": "slow_link",
        }
    return {
        "culprit": culprit,
        "rows_total": links.get("rows_total", len(rows)),
        "rows_wan": len(wan),
        "hosts": links.get("hosts"),
        "version": links.get("version"),
        "median_wan_goodput_bps": med,
        "slow_links": [
            {
                "src": r.get("src"),
                "peer": r.get("peer"),
                "plane": r.get("plane"),
                "goodput_bps": float(r.get("goodput_bps") or 0.0),
                "rtt_p99_ms": float(r.get("rtt_p99_ms") or 0.0),
                "samples": int(r.get("samples") or 0),
            }
            for r in slow
        ],
    }


def analyze_fragment(
    entries: "List[Dict[str, Any]]", frag: str
) -> "Dict[str, Any]":
    """One fragment's journey + the ``poisoned_hop`` culprit signal.

    Replays every ``fragment.hold`` / ``fragment.hop`` provenance record
    for ``frag`` (frag_id ``"<payload>/<index>"``, e.g. ``weights/0``)
    out of the already-merged dump timeline — the ``.prov`` companions
    the provenance registry dumps alongside ``TORCHFT_FLIGHT_FILE`` use
    the same JSONL format, so they load through :func:`load_records`
    unchanged.  The journey is publish -> relay hops -> client / heal
    destination / durable store, ordered by start time across every
    process that dumped.  The FIRST hop whose digest verdict is
    ``mismatch`` or ``torn`` is where bad bytes entered the plane: its
    SOURCE is the culprit (every receiver downstream of it sees the same
    mismatch and is a victim, not a cause) — attribution needs no live
    fleet, only the serialized dumps."""
    journey = [
        e
        for e in entries
        if e.get("op") in ("fragment.hold", "fragment.hop")
        and str((e.get("fields") or {}).get("frag", "")) == frag
    ]
    journey.sort(key=lambda e: e.get("start_ns") or e.get("t_ns") or 0)
    hops = [e for e in journey if e["op"] == "fragment.hop"]
    holds = [e for e in journey if e["op"] == "fragment.hold"]
    poisoned: "Optional[Dict[str, Any]]" = None
    for e in hops:
        if str(e["fields"].get("verdict", "ok")) in ("mismatch", "torn"):
            poisoned = e
            break
    culprit: "Optional[Dict[str, Any]]" = None
    if poisoned is not None:
        f = poisoned["fields"]
        source = str(f.get("source", "?"))
        holder = str(f.get("holder", "?"))
        verdict = str(f.get("verdict", "?"))
        culprit = {
            "replica_id": source,
            "reason": (
                f"fragment {frag} v{f.get('version')} arrived '{verdict}' "
                f"at {holder} over the {f.get('plane')} plane — {source} "
                f"is the first hop where the digest broke ({len(hops)} "
                f"hop(s) audited)"
            ),
            "frag": frag,
            "version": f.get("version"),
            "plane": f.get("plane"),
            "verdict": verdict,
            "holder": holder,
            "signal": "poisoned_hop",
        }
    return {
        "frag": frag,
        "holds": len(holds),
        "hops": len(hops),
        "journey": journey,
        "poisoned_hop": dict(poisoned["fields"]) if poisoned else None,
        "culprit": culprit,
    }


def apply_wire_split(
    trace_report: "Dict[str, Any]", links_report: "Dict[str, Any]"
) -> None:
    """Annotate the critical-path ledger with the expected-vs-excess wire
    split, in place.

    The ledger knows how long the wire was busy (``wire`` seconds); the
    link matrix knows how fast the wire actually ran vs the fleet.  For
    each step's critical replica: the same traffic on a fleet-median
    link would have taken ``wire_s * (slow / median)`` — that is the
    **expected** share; the rest is **excess**, the slow link's
    surcharge.  With no sustained slow link the split is degenerate
    (everything expected) and nothing is annotated — the split exists to
    quantify a named culprit, not to invent one."""
    slow = links_report.get("slow_links") or []
    med = float(links_report.get("median_wan_goodput_bps") or 0.0)
    if not slow or med <= 0.0:
        return
    g = float(slow[0]["goodput_bps"])
    if g <= 0.0 or g >= med:
        return
    frac_expected = g / med
    for step in trace_report.get("steps") or []:
        info = step["replicas"].get(step["critical_replica"]) or {}
        wire_s = float((info.get("categories") or {}).get("wire") or 0.0)
        if wire_s <= 0.0:
            continue
        step["wire_expected_s"] = round(wire_s * frac_expected, 6)
        step["wire_excess_s"] = round(wire_s * (1.0 - frac_expected), 6)
        step["wire_slow_link"] = f"{slow[0]['src']}->{slow[0]['peer']}"


def _span_dur_s(span: "Dict[str, Any]") -> float:
    try:
        return max(
            (int(span.get("end_ns") or 0) - int(span.get("start_ns") or 0))
            / 1e9,
            0.0,
        )
    except (TypeError, ValueError):
        return 0.0


def analyze_trace(spans: "List[Dict[str, Any]]") -> "Dict[str, Any]":
    """The per-step critical-path ledger from a span-sink file.

    One trace == one training step (ids are deterministic per step), with
    one ``quorum_round`` root per replica and every other span a child of
    some replica's root (phase spans, native ``rpc.*`` server spans, heal
    spans, the quantized-pipeline spans).  Per replica the ledger sums:

    - the **phase spans** (the Manager's own non-overlapping accounting)
      through :data:`PHASE_CATEGORY`;
    - ``quant.pipeline``'s ``codec_s``/``wire_s`` attributes, which
      REPLACE the ``ring`` phase when present (ring wraps the pipeline —
      counting both would double-bill the wire);
    - the lighthouse's ``rpc.quorum`` server span, which REFINES
      straggler-wait (it measures exactly the block-until-quorum-forms
      wait; the ``quorum_wait`` phase then only contributes any excess).

    Mirror spans (``heal.send``/``heal.recv``, per-chunk ``quant.chunk``,
    manager/store ``rpc.*``) join endpoints causally but are excluded
    from the sums — their cost is already inside a phase.  The step's
    critical path is the slowest replica's root; its dominant category is
    the step's answer to "what ate this step".  Any ``ok=false`` span
    names a culprit (signal ``trace_error``) with no other input needed.
    """
    by_trace: "Dict[str, List[Dict[str, Any]]]" = defaultdict(list)
    for s in spans:
        by_trace[str(s.get("trace_id"))].append(s)

    steps: "List[Dict[str, Any]]" = []
    culprit: "Optional[Dict[str, Any]]" = None
    for trace_id, sp in by_trace.items():
        roots = [s for s in sp if s.get("name") == "quorum_round"]
        if not roots:
            continue
        step = (roots[0].get("attributes") or {}).get("step")
        quorum_id = (roots[0].get("attributes") or {}).get("quorum_id")
        root_ids = {s.get("span_id"): s for s in roots}
        children: "Dict[str, List[Dict[str, Any]]]" = defaultdict(list)
        for s in sp:
            parent = s.get("parent_span_id")
            if parent in root_ids and s.get("name") != "quorum_round":
                children[parent].append(s)

        replicas: "Dict[str, Dict[str, Any]]" = {}
        for root in roots:
            attrs = root.get("attributes") or {}
            rid = str(attrs.get("replica_id", "?"))
            info = replicas.setdefault(
                rid,
                {
                    "wall_s": 0.0,
                    "categories": {},
                    "ok": True,
                    "spans": 0,
                    "failed_span": None,
                },
            )
            info["wall_s"] += _span_dur_s(root)
            if not root.get("ok", True):
                info["ok"] = False
                info["failed_span"] = info["failed_span"] or "quorum_round"
            cats: "Dict[str, float]" = info["categories"]
            phase_sums: "Dict[str, float]" = {}
            quant_seen = False
            lighthouse_wait = 0.0
            kids = children.get(root.get("span_id"), [])
            info["spans"] += 1 + len(kids)
            for c in kids:
                name = str(c.get("name"))
                cattrs = c.get("attributes") or {}
                if not c.get("ok", True):
                    info["ok"] = False
                    info["failed_span"] = info["failed_span"] or name
                if name in PHASE_CATEGORY:
                    phase_sums[name] = phase_sums.get(name, 0.0) + _span_dur_s(c)
                elif name == "quant.pipeline":
                    quant_seen = True
                    cats["codec"] = cats.get("codec", 0.0) + float(
                        cattrs.get("codec_s") or 0.0
                    )
                    cats["wire"] = cats.get("wire", 0.0) + float(
                        cattrs.get("wire_s") or 0.0
                    )
                elif name == "rpc.quorum" and cattrs.get("server") == "lighthouse":
                    lighthouse_wait += _span_dur_s(c)
                # mirror spans (heal.*, quant.chunk, other rpc.*): causal
                # join only — their cost is inside a phase already
            if quant_seen:
                phase_sums.pop("ring", None)
            if lighthouse_wait > 0.0:
                # the measured block-until-quorum wait replaces the phase;
                # quorum_wait only contributes any excess beyond it
                excess = max(phase_sums.get("quorum_wait", 0.0) - lighthouse_wait, 0.0)
                phase_sums["quorum_wait"] = excess
                cats["straggler-wait"] = (
                    cats.get("straggler-wait", 0.0) + lighthouse_wait
                )
            for cat, v in ledger_categories(phase_sums).items():
                cats[cat] = cats.get(cat, 0.0) + v

        for rid, info in replicas.items():
            # argmax over the already-categorized sums (NOT through
            # dominant_contributor, which maps phase names to categories)
            info["dominant"] = (
                max(info["categories"].items(), key=lambda kv: kv[1])[0]
                if info["categories"]
                and max(info["categories"].values()) > 0.0
                else None
            )
            info["categories"] = {
                k: round(v, 6) for k, v in sorted(info["categories"].items())
            }
            info["wall_s"] = round(info["wall_s"], 6)

        slowest = max(replicas.items(), key=lambda kv: kv[1]["wall_s"])
        # the slowest replica IS the step's critical path; its dominant
        # category answers "what ate this step" (same >0 guard as the
        # per-replica dominant — all-zero sums name nothing)
        dominant = (
            max(slowest[1]["categories"].items(), key=lambda kv: kv[1])[0]
            if slowest[1]["categories"]
            and max(slowest[1]["categories"].values()) > 0.0
            else None
        )
        starts = [int(s.get("start_ns") or 0) for s in roots]
        ends = [int(s.get("end_ns") or 0) for s in roots]
        steps.append(
            {
                "step": step,
                "quorum_id": quorum_id,
                "trace_id": trace_id,
                "wall_s": round((max(ends) - min(starts)) / 1e9, 6),
                "replicas": replicas,
                "critical_replica": slowest[0],
                "dominant": dominant,
            }
        )
    steps.sort(key=lambda s: (s["step"] is None, s["step"]))
    for s in steps:
        failed = [
            (rid, info)
            for rid, info in s["replicas"].items()
            if not info["ok"]
        ]
        if failed and culprit is None:
            # earliest failing step wins (later failures are cascade)
            rid, info = failed[0]
            culprit = {
                "replica_id": rid,
                "reason": (
                    f"trace: span {info['failed_span']!r} failed (ok=false) "
                    f"at step {s['step']}"
                ),
                "signal": "trace_error",
            }
    # The category that dominates the most steps.  A tie goes to the
    # category with more critical-path seconds over all steps, then to the
    # first in LEDGER_CATEGORIES: the JAX package breaks it by a set's
    # iteration order, which follows the interpreter's string hash seed, so
    # two runs on the same files could name different categories there.
    dominants = [s["dominant"] for s in steps if s["dominant"]]
    seconds: "Dict[str, float]" = defaultdict(float)
    for s in steps:
        crit = s["replicas"].get(s["critical_replica"]) or {}
        for cat, v in (crit.get("categories") or {}).items():
            seconds[cat] += float(v)
    overall = (
        max(
            sorted(set(dominants), key=LEDGER_CATEGORIES.index),
            key=lambda c: (dominants.count(c), seconds[c]),
        )
        if dominants
        else None
    )
    return {
        "steps": steps,
        "spans": len(spans),
        "traces": len(by_trace),
        "dominant_overall": overall,
        "culprit": culprit,
    }


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def _fmt_t(t_ns: int, t0_ns: int) -> str:
    return f"+{(t_ns - t0_ns) / 1e9:9.3f}s"


def render_text(
    entries: "List[Dict[str, Any]]",
    report: "Dict[str, Any]",
    warnings: "List[str]",
    max_rows: int = 200,
) -> str:
    out: "List[str]" = []
    culprit = report["culprit"]
    out.append("torchft-torch-diagnose")
    out.append("=" * 60)
    if culprit:
        out.append(
            f"LIKELY CULPRIT: {culprit['replica_id']}  "
            f"[{culprit['signal']}]"
        )
        out.append(f"  {culprit['reason']}")
    else:
        out.append("LIKELY CULPRIT: none identified (no failure signature)")
    failure = report["failure"]
    if failure:
        out.append(
            f"FAILED PHASE: {failure['phase']} at step={failure['step']} "
            f"quorum_id={failure['quorum_id']} "
            f"(first reported by {failure['reported_by'] or '?'})"
        )
        if failure["detail"]:
            out.append(f"  detail: {failure['detail']}")
    for storm in report["retry_storms"]:
        out.append(
            f"RETRY STORM: {storm['retries']}x {storm['op']} "
            f"on {storm['replica_id'] or '?'}"
        )
    out.append("")
    out.append("replicas:")
    for rid, info in sorted(report["replicas"].items()):
        out.append(
            f"  {rid:32s} max_step={info['max_step']:<5d} "
            f"records={info['records']:<5d} errors={info['errors']}"
        )
    if warnings:
        out.append("")
        for w in warnings:
            out.append(f"warning: {w}")
    out.append("")
    out.append(f"timeline ({min(len(entries), max_rows)} of {len(entries)} entries):")
    t0 = entries[0]["t_ns"] if entries else 0
    shown = entries if len(entries) <= max_rows else entries[-max_rows:]
    for e in shown:
        step = e.get("step")
        q = e.get("quorum_id")
        ctx = f"step={step}" if step is not None else ""
        if q is not None:
            ctx += f" q={q}"
        marker = "!" if e["status"] in _ERROR_STATUSES else (
            "~" if e["status"] == "fault" else " ")
        out.append(
            f" {marker} {_fmt_t(e['t_ns'], t0)} {e['replica_id'][:28]:28s} "
            f"{e['op']:24s} {e['status']:8s} {ctx}"
        )
    return "\n".join(out)


def render_timeline_text(
    timeline: "Dict[str, Any]", max_rows: int = 30
) -> str:
    """The cluster step-timeline as a text section: one row per step
    bucket (replicas seen, wall span, codec/wire busy, slowest phase)
    plus the worst-straggler snapshot."""
    out: "List[str]" = []
    steps = timeline.get("steps") or []
    out.append(
        f"cluster timeline ({min(len(steps), max_rows)} of {len(steps)} "
        f"step buckets, ring {timeline.get('ring')}):"
    )
    for b in steps[-max_rows:]:
        phases = b.get("phases") or {}
        slowest = max(
            phases.items(), key=lambda kv: kv[1].get("mean_ms", 0.0), default=None
        )
        slow_txt = (
            f" slowest {slowest[0]} {slowest[1].get('mean_ms', 0.0):.1f}ms "
            f"(max {slowest[1].get('max_ms', 0.0):.1f})"
            if slowest
            else ""
        )
        busy = ""
        if b.get("codec_busy_s") or b.get("wire_busy_s"):
            busy = (
                f" codec {b.get('codec_busy_s', 0.0):.2f}s"
                f" wire {b.get('wire_busy_s', 0.0):.2f}s"
            )
        out.append(
            f"  step {b.get('step'):<6} replicas={b.get('replicas'):<4} "
            f"span={b.get('span_ms', 0)}ms{busy}{slow_txt}"
        )
    worst = timeline.get("stragglers_worst") or []
    if worst:
        out.append("worst stragglers (lighthouse snapshot):")
        for row in worst:
            out.append(
                f"  {str(row.get('replica_id', '?')):32s} "
                f"score={float(row.get('straggler_score') or 0.0):6.1f} "
                f"lag={row.get('step_lag')} "
                f"{'STALE' if row.get('stale') else 'fresh'} "
                f"op={row.get('inflight_op') or '-'}"
            )
    return "\n".join(out)


def render_links_text(
    links: "Dict[str, Any]",
    links_report: "Dict[str, Any]",
    max_rows: int = 15,
) -> str:
    """The fleet link matrix as a text section: worst WAN links first
    (goodput ascending), the fleet median for scale, and any sustained
    slow-link outliers called out."""
    out: "List[str]" = []
    rows = [
        r
        for r in (links.get("rows") or [])
        if isinstance(r, dict) and not r.get("local")
    ]
    rows.sort(key=lambda r: float(r.get("goodput_bps") or 0.0))
    med = float(links_report.get("median_wan_goodput_bps") or 0.0)
    out.append(
        f"fleet link matrix ({min(len(rows), max_rows)} of {len(rows)} WAN "
        f"links, {links_report.get('hosts')} hosts, "
        f"median {med / 1e6:.1f} MB/s):"
    )
    for r in rows[:max_rows]:
        g = float(r.get("goodput_bps") or 0.0)
        ratio = f" ({med / g:.1f}x below median)" if med > 0 < g < med else ""
        out.append(
            f"  {str(r.get('src', '?'))[:20]:20s} -> "
            f"{str(r.get('peer', '?'))[:20]:20s} {str(r.get('plane')):10s} "
            f"{g / 1e6:8.1f} MB/s  rtt p99 "
            f"{float(r.get('rtt_p99_ms') or 0.0):7.1f}ms  "
            f"samples={r.get('samples')}{ratio}"
        )
    for s in links_report.get("slow_links") or []:
        out.append(
            f"  SLOW LINK: {s['src']}->{s['peer']} ({s['plane']}) "
            f"{s['goodput_bps'] / 1e6:.1f} MB/s sustained over "
            f"{s['samples']} samples"
        )
    return "\n".join(out)


def render_fragment_text(
    frag_report: "Dict[str, Any]", max_rows: int = 60
) -> str:
    """One fragment's journey as a text section: every hold and hop in
    time order (holder, role, plane, digest verdict), the poisoned hop
    called out when a mismatch/torn verdict entered the plane."""
    out: "List[str]" = []
    journey = frag_report.get("journey") or []
    out.append(
        f"fragment journey {frag_report['frag']} "
        f"({frag_report.get('holds')} hold(s), "
        f"{frag_report.get('hops')} hop(s)):"
    )
    if not journey:
        out.append(
            "  no provenance records for this fragment — pass the .prov "
            "companion dumps written alongside TORCHFT_FLIGHT_FILE"
        )
        return "\n".join(out)
    t0 = min(e.get("start_ns") or e.get("t_ns") or 0 for e in journey)
    for e in journey[:max_rows]:
        f = e.get("fields") or {}
        t = _fmt_t(e.get("start_ns") or e.get("t_ns") or 0, t0)
        if e["op"] == "fragment.hold":
            out.append(
                f"  {t}  HELD v{f.get('version')!s:<4} by "
                f"{str(f.get('holder', '?'))[:28]:28s} "
                f"[{f.get('role', 'holder')}] "
                f"digest={f.get('digest8') or '-'}"
            )
        else:
            verdict = str(f.get("verdict", "ok"))
            out.append(
                f"  {t}  HOP  v{f.get('version')!s:<4} "
                f"{str(f.get('source', '?'))[:28]:28s} -> "
                f"{str(f.get('holder', '?'))[:28]:28s} "
                f"({f.get('plane')}) {verdict.upper()} "
                f"{f.get('bytes', 0)}B fb={f.get('first_byte_ms', 0)}ms"
            )
    poisoned = frag_report.get("poisoned_hop")
    if poisoned:
        out.append(
            f"  POISONED HOP: {poisoned.get('source')} -> "
            f"{poisoned.get('holder')} ({poisoned.get('plane')}) verdict="
            f"{poisoned.get('verdict')} at v{poisoned.get('version')} — "
            f"first hop where the digest broke"
        )
    return "\n".join(out)


def render_trace_text(trace_report: "Dict[str, Any]", max_rows: int = 30) -> str:
    """The per-step critical-path ledger as a text section: one row per
    step (wall, critical replica, dominant category, category split) plus
    per-replica dominants."""
    out: "List[str]" = []
    steps = trace_report.get("steps") or []
    out.append(
        f"critical-path ledger ({min(len(steps), max_rows)} of {len(steps)} "
        f"steps, {trace_report.get('spans')} spans):"
    )
    if trace_report.get("dominant_overall"):
        out.append(
            f"  dominant contributor overall: "
            f"{trace_report['dominant_overall']}"
        )
    for s in steps[-max_rows:]:
        cats = s["replicas"][s["critical_replica"]]["categories"]
        split = " ".join(
            f"{c}={cats.get(c, 0.0) * 1e3:.1f}ms"
            for c in LEDGER_CATEGORIES
            if cats.get(c)
        )
        out.append(
            f"  step {s['step']!s:<6} wall={s['wall_s'] * 1e3:8.1f}ms "
            f"critical={s['critical_replica'][:28]:28s} "
            f"dominant={s['dominant'] or '-':<14} {split}"
        )
        if "wire_excess_s" in s:
            out.append(
                f"      wire split vs fleet-median link: expected "
                f"{s['wire_expected_s'] * 1e3:.1f}ms + excess "
                f"{s['wire_excess_s'] * 1e3:.1f}ms "
                f"(slow link {s['wire_slow_link']})"
            )
        for rid, info in sorted(s["replicas"].items()):
            marker = " " if info["ok"] else "!"
            out.append(
                f"   {marker}  {rid[:30]:30s} wall={info['wall_s'] * 1e3:8.1f}ms "
                f"dominant={info['dominant'] or '-'}"
                + (
                    f" FAILED in {info['failed_span']}"
                    if not info["ok"]
                    else ""
                )
            )
    culprit = trace_report.get("culprit")
    if culprit:
        out.append(
            f"  trace culprit: {culprit['replica_id']} — {culprit['reason']}"
        )
    return "\n".join(out)


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------


def _synthetic_dumps(tmpdir: str) -> "Tuple[str, str]":
    """Two replicas: replica_b silently dies at step 3; replica_a's
    allreduce then fails.  Written in the exact flight-dump format."""
    t0 = time.time_ns()
    s = 1_000_000_000  # 1s in ns

    def rec(**kw: Any) -> "Dict[str, Any]":
        return {"flight": "rec", **kw}

    a_records: "List[Dict[str, Any]]" = []
    b_records: "List[Dict[str, Any]]" = []
    for step in range(4):
        for rid, records in (("replica_a:u1", a_records), ("replica_b:u2", b_records)):
            if rid.startswith("replica_b") and step >= 3:
                continue  # b died before step 3's collective
            base = t0 + step * s + (0 if rid.startswith("replica_a") else 10_000_000)
            records.append(
                rec(op="quorum_rpc", status="ok", start_ns=base,
                    end_ns=base + 5_000_000, replica_id=rid, step=step,
                    quorum_id=1, kind="phase")
            )
            records.append(
                rec(op="allreduce", status="ok", start_ns=base + 6_000_000,
                    end_ns=base + 9_000_000, replica_id=rid, step=step,
                    quorum_id=1, kind="collective", rank=0, world=2)
            )
    # b entered step 3's quorum then vanished
    b_base = t0 + 3 * s
    b_records.append(
        rec(op="quorum_rpc", status="ok", start_ns=b_base,
            end_ns=b_base + 5_000_000, replica_id="replica_b:u2", step=3,
            quorum_id=1, kind="phase")
    )
    # a's step-3 collective fails ~10s later (peer gone, deadline expired)
    a_fail = t0 + 13 * s
    a_records.append(
        rec(op="allreduce", status="error", start_ns=t0 + 3 * s,
            end_ns=a_fail, replica_id="replica_a:u1", step=3, quorum_id=1,
            kind="collective", rank=0, world=2,
            reason="collective failed: ConnectionError('peer closed connection')")
    )

    def write(name: str, records: "List[Dict[str, Any]]") -> str:
        path = os.path.join(tmpdir, name)
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(json.dumps({
                "flight": "meta", "reason": "selftest", "trigger": "manual",
                "ts": t0 / 1e9, "pid": 0, "records": len(records),
            }) + "\n")
            for r in records:
                fh.write(json.dumps(r) + "\n")
        return path

    return write("replica_a.jsonl", a_records), write("replica_b.jsonl", b_records)


def _synthetic_prov_dump(tmpdir: str) -> str:
    """One ``.prov`` companion dump: fragment weights/0 publishes clean,
    relay_mid serves poisoned bytes (the client's digest check fires),
    and a downstream client sees the same mismatch — the exact trail the
    provenance registry dumps."""
    t0 = time.time_ns()
    ms = 1_000_000  # 1ms in ns
    records = [
        {"flight": "rec", "op": "fragment.hold", "status": "ok",
         "start_ns": t0, "end_ns": t0, "frag": "weights/0", "version": 7,
         "digest8": "aaaaaaaa", "version_ms": 1000, "holder": "pub:1",
         "role": "publisher"},
        {"flight": "rec", "op": "fragment.hop", "status": "ok",
         "start_ns": t0 + ms, "end_ns": t0 + 2 * ms, "frag": "weights/0",
         "version": 7, "source": "http://pub:1", "plane": "serving",
         "verdict": "ok", "bytes": 4096, "first_byte_ms": 0.4,
         "holder": "relay_mid:2"},
        {"flight": "rec", "op": "fragment.hop", "status": "error",
         "start_ns": t0 + 3 * ms, "end_ns": t0 + 4 * ms,
         "frag": "weights/0", "version": 7, "source": "http://relay_mid:2",
         "plane": "serving", "verdict": "mismatch", "bytes": 4096,
         "first_byte_ms": 0.6, "holder": "client:3"},
        {"flight": "rec", "op": "fragment.hop", "status": "error",
         "start_ns": t0 + 5 * ms, "end_ns": t0 + 6 * ms,
         "frag": "weights/0", "version": 7, "source": "http://client:3",
         "plane": "serving", "verdict": "mismatch", "bytes": 4096,
         "first_byte_ms": 0.5, "holder": "leaf:4"},
    ]
    path = os.path.join(tmpdir, "flight.jsonl.prov")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(json.dumps({
            "flight": "meta", "reason": "selftest", "trigger": "manual",
            "ts": t0 / 1e9, "pid": 0, "records": len(records),
        }) + "\n")
        for r in records:
            fh.write(json.dumps(r) + "\n")
    return path


def selftest(verbose: bool = True) -> bool:
    """Synthetic two-replica dump pair through the full pipeline; the
    culprit must be the silently-dead replica_b and the failed phase the
    surviving replica's collective.  A synthetic provenance dump then
    checks ``--fragment`` attribution: the FIRST mismatching hop's
    source (the mid-tree relay) must be the ``poisoned_hop`` culprit,
    not the downstream victims."""
    with tempfile.TemporaryDirectory() as tmpdir:
        dump_a, dump_b = _synthetic_dumps(tmpdir)
        entries, warnings = load_records([dump_a, dump_b])
        report = analyze(entries)
        prov_entries, prov_warnings = load_records(
            [_synthetic_prov_dump(tmpdir)]
        )
        frag_report = analyze_fragment(prov_entries, "weights/0")
    ok = True

    def check(cond: bool, what: str) -> None:
        nonlocal ok
        if not cond:
            ok = False
            print(f"selftest FAIL: {what}", file=sys.stderr)

    check(len(entries) > 0, "no entries parsed")
    check(not warnings, f"unexpected warnings: {warnings}")
    check(report["culprit"] is not None, "no culprit identified")
    if report["culprit"]:
        check(
            report["culprit"]["replica_id"].startswith("replica_b"),
            f"culprit {report['culprit']} is not replica_b",
        )
    check(
        report["failure"] is not None
        and report["failure"]["phase"] == "allreduce"
        and report["failure"]["step"] == 3,
        f"failure {report['failure']} is not allreduce@3",
    )
    check(not prov_warnings, f"prov warnings: {prov_warnings}")
    check(
        frag_report["hops"] == 3 and frag_report["holds"] == 1,
        f"fragment journey miscounted: {frag_report['hops']} hops, "
        f"{frag_report['holds']} holds",
    )
    check(
        frag_report["culprit"] is not None
        and frag_report["culprit"]["signal"] == "poisoned_hop"
        and frag_report["culprit"]["replica_id"] == "http://relay_mid:2",
        f"poisoned_hop culprit wrong: {frag_report['culprit']}",
    )
    check(
        bool(render_fragment_text(frag_report)),
        "fragment renderer produced nothing",
    )
    if ok and verbose:
        print(
            "selftest OK: culprit=replica_b, failed phase=allreduce@3, "
            "poisoned_hop=relay_mid"
        )
    return ok


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: "Optional[List[str]]" = None) -> int:
    parser = argparse.ArgumentParser(
        prog="torchft-torch-diagnose",
        description=(
            "Merge torchft flight dumps (TORCHFT_FLIGHT_FILE) and event "
            "logs (TORCHFT_EVENTS_FILE) into a cross-replica timeline and "
            "flag the likely culprit."
        ),
    )
    parser.add_argument("dumps", nargs="*", help="flight dump JSONL file(s)")
    parser.add_argument(
        "--events", action="append", default=[],
        help="TORCHFT_EVENTS_FILE JSONL log(s) to merge (repeatable)",
    )
    parser.add_argument(
        "--timeline", default=None, metavar="FILE_OR_URL",
        help="lighthouse /timeline.json (file, URL, or host:port) to fold "
        "into the report — names a straggler culprit even without dumps",
    )
    parser.add_argument(
        "--links", default=None, metavar="FILE_OR_URL",
        help="lighthouse /links.json (file, URL, or host:port) to fold "
        "into the report — names a sustained slow host-pair link "
        "(signal slow_link) and, with --trace, splits the ledger's wire "
        "cost into expected vs excess against the fleet-median link",
    )
    parser.add_argument(
        "--fragment", default=None, metavar="FRAG_ID",
        help="reconstruct this fragment's journey (frag_id like "
        "weights/0) from fragment.hold/fragment.hop provenance records "
        "in the given dumps (pass the TORCHFT_FLIGHT_FILE.prov "
        "companions as positional dumps) and name the hop where a "
        "digest mismatch first entered (signal poisoned_hop)",
    )
    parser.add_argument(
        "--trace", default=None, metavar="TRACE_FILE",
        help="distributed-tracing span sink (TORCHFT_TRACE_FILE JSONL): "
        "reconstructs the per-step cross-replica critical-path ledger "
        "(compute/codec/wire/protocol/straggler-wait) and names failing "
        "replicas from ok=false spans",
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable JSON report"
    )
    parser.add_argument(
        "--max-rows", type=int, default=200,
        help="timeline rows shown in text output (default 200)",
    )
    parser.add_argument(
        "--selftest", action="store_true",
        help="synthetic two-replica attribution check (CI hook)",
    )
    args = parser.parse_args(argv)

    if args.selftest:
        return 0 if selftest() else 1
    if (
        not args.dumps
        and not args.events
        and not args.timeline
        and not args.trace
        and not args.links
    ):
        parser.print_usage(sys.stderr)
        print("torchft-torch-diagnose: no input files", file=sys.stderr)
        return 2

    cluster_timeline: "Optional[Dict[str, Any]]" = None
    timeline_report: "Optional[Dict[str, Any]]" = None
    if args.timeline:
        try:
            cluster_timeline = load_timeline(args.timeline)
            timeline_report = analyze_timeline(cluster_timeline)
        except Exception as e:  # noqa: BLE001 - report, don't die mid-postmortem
            print(f"warning: --timeline {args.timeline}: {e}", file=sys.stderr)

    links_doc: "Optional[Dict[str, Any]]" = None
    links_report: "Optional[Dict[str, Any]]" = None
    if args.links:
        try:
            links_doc = load_links(args.links)
            links_report = analyze_links(links_doc)
        except Exception as e:  # noqa: BLE001 - report, don't die mid-postmortem
            print(f"warning: --links {args.links}: {e}", file=sys.stderr)

    trace_report: "Optional[Dict[str, Any]]" = None
    trace_warnings: "List[str]" = []
    if args.trace:
        spans, trace_warnings = load_spans(args.trace)
        if spans:
            trace_report = analyze_trace(spans)
        elif not trace_warnings:
            trace_warnings = [f"{args.trace}: no spans"]

    entries, warnings = load_records(list(args.dumps), list(args.events))
    warnings.extend(trace_warnings)
    if (
        not entries
        and timeline_report is None
        and trace_report is None
        and links_report is None
    ):
        for w in warnings:
            print(f"warning: {w}", file=sys.stderr)
        print("torchft-torch-diagnose: no parseable records", file=sys.stderr)
        return 1
    report = analyze(entries)
    frag_report: "Optional[Dict[str, Any]]" = None
    if args.fragment:
        frag_report = analyze_fragment(entries, args.fragment)
    if trace_report is not None and links_report is not None:
        apply_wire_split(trace_report, links_report)
    # Culprit precedence: a poisoned fragment hop answers the question
    # --fragment explicitly asked, so it overrides everything when found;
    # otherwise flight-record signals see INSIDE a replica and win when
    # present; the trace ledger's ok=false spans are next (they also see
    # inside, but dumps carry the fault tags); the lighthouse timeline
    # sees the fleet from outside; the link matrix is last — a slow wire
    # is a degradation, not a failure, so any failure signature outranks
    # it.  All inputs join into one report.
    if frag_report is not None and frag_report["culprit"] is not None:
        report["culprit"] = frag_report["culprit"]
    if report["culprit"] is None and trace_report is not None:
        report["culprit"] = trace_report["culprit"]
    if report["culprit"] is None and timeline_report is not None:
        report["culprit"] = timeline_report["culprit"]
    if report["culprit"] is None and links_report is not None:
        report["culprit"] = links_report["culprit"]
    if timeline_report is not None:
        report["cluster_timeline"] = timeline_report
    if links_report is not None:
        report["link_matrix"] = links_report
    if frag_report is not None:
        report["fragment_journey"] = frag_report
    if trace_report is not None:
        report["trace_ledger"] = trace_report
    if args.json:
        payload = dict(report)
        payload["warnings"] = warnings
        payload["timeline"] = entries
        print(json.dumps(payload, indent=2, default=str))
    else:
        print(render_text(entries, report, warnings, max_rows=args.max_rows))
        if cluster_timeline is not None:
            print(render_timeline_text(cluster_timeline))
        if links_doc is not None and links_report is not None:
            print(render_links_text(links_doc, links_report))
        if frag_report is not None:
            print(render_fragment_text(frag_report))
        if trace_report is not None:
            print(render_trace_text(trace_report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
