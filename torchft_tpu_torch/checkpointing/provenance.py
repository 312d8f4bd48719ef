"""Fragment provenance plane: per-fragment version vectors + hop audit.

PyTorch port of ``torchft_tpu/checkpointing/provenance.py``.  One
difference: the digest rate limit starts from "never reported" (``None``),
not from a monotonic time of 0.0, so the first digest is always sent, even
on a host whose ``time.monotonic()`` still reads less than
``TORCHFT_FRAG_REPORT_S`` (a freshly booted machine or container).

The fragment is the system's universal wire unit — serving relay
striped heal, durable spill/restore
all move digest-manifested fragments — yet until this module every
observability surface spoke at node or whole-model granularity.
ROADMAP item 1 (continuous multi-publisher serving) needs the fleet to
answer: *which version of fragment f is held where, how stale is it,
and which hops did these exact bytes traverse?*  This registry is the
process-local half of that answer:

- **Stable fragment identity.**  ``frag_id(payload, index)`` =
  ``"<payload>/<index>"`` — the payload family (``weights`` for serving
  documents, ``heal`` for heal streams) plus the round-robin layout
  index that names the fragment everywhere in the plane
  (``fragments.fragment_slots``).  The id is version-free on purpose:
  the vector tracks *which version of that slot* a holder has.

- **Per-fragment version vector.**  Every holder — publisher, serving
  relay, serving client, heal destination, durable store — calls
  :func:`note_hold` at stage/verify/spill time; the vector entry keeps
  ``(version, digest8, held_since_ms, version_ms)`` where ``version_ms``
  is the manifest's publish stamp (``created_ns`` // 1e6, the
  publisher's clock) carried unmodified — so fleet-side staleness is a
  difference of two stamps from ONE clock, skew-free (the link-state ledger
  generalized down to the fragment).

- **Hop-level audit.**  Every fragment transfer on any plane appends a
  ``fragment.hop`` record (source host, plane ∈ {serving, heal,
  restore}, digest verdict ok/mismatch/torn, bytes, first-byte ms) to a
  bounded private :class:`~torchft_tpu_torch.utils.flightrecorder.
  FlightRecorder` ring (``TORCHFT_FRAG_RING``, default 1024) — same
  ~1 us/record budget discipline, same JSONL dump format, dumped
  crash-durably *alongside* ``TORCHFT_FLIGHT_FILE`` (``<path>.prov``)
  via the flight recorder's companion hook.  ``torchft-torch-diagnose
  --fragment <id>`` replays a fragment's whole journey from these dumps
  alone and names the hop where a mismatch first entered
  (``poisoned_hop``).

- **Fleet aggregation.**  :meth:`ProvenanceRegistry.maybe_digest` emits
  a bounded digest (worst-K stalest + changed-since-last-report,
  ``TORCHFT_FRAG_TOPK`` / ``TORCHFT_FRAG_REPORT_S``) that manager and
  serving heartbeats piggyback — consumed-on-send, restored on RPC
  failure via :meth:`ProvenanceRegistry.restore_digest`, exactly the
  links-digest contract.  The lighthouse folds reports into the
  per-(host, frag_id) version matrix served at ``/fragments.json``.

Failure policy matches every telemetry surface: provenance must never
fail a transfer — all public entry points swallow their own errors.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional

from torchft_tpu_torch.utils import flightrecorder as _flightrec
from torchft_tpu_torch.utils.env import env_float, env_int

logger = logging.getLogger(__name__)

__all__ = [
    "PLANES",
    "VERDICTS",
    "frag_id",
    "ProvenanceRegistry",
    "PROV",
    "note_hold",
    "note_hop",
]

#: transfer planes a fragment hop can ride
PLANES = ("serving", "heal", "restore")

#: digest verdicts a hop can carry: ``ok`` (verified), ``mismatch``
#: (wire bytes hash differently than the manifest), ``torn`` (a durable
#: blob failed its content-address check at read time)
VERDICTS = ("ok", "mismatch", "torn")

_DEFAULT_RING = 1024


def frag_id(payload: str, index: Any) -> str:
    """The stable fragment identity: payload family + layout index."""
    return f"{payload}/{index}"


class _Held:
    """One vector entry.  Mutated only under the registry lock."""

    __slots__ = ("version", "digest8", "held_since_ms", "version_ms", "pub")

    def __init__(self) -> None:
        self.version = 0
        self.digest8 = ""
        self.held_since_ms = 0
        self.version_ms = 0
        self.pub = False

    def to_row(self, fid: str) -> "Dict[str, Any]":
        row: "Dict[str, Any]" = {
            "frag": fid,
            "version": self.version,
            "digest8": self.digest8,
            "held_ms": self.held_since_ms,
            "version_ms": self.version_ms,
        }
        if self.pub:
            row["pub"] = True
        return row


class ProvenanceRegistry:
    """The process-wide fragment provenance table (module global
    ``PROV``): version vector + hop ring + heartbeat digest."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._vector: "Dict[str, _Held]" = {}
        # changed-since-last-report set (consumed by maybe_digest)
        self._dirty: "set[str]" = set()
        self._topk = env_int("TORCHFT_FRAG_TOPK", 16, minimum=1)
        self._report_s = env_float("TORCHFT_FRAG_REPORT_S", 2.0, minimum=0.0)
        # None = never reported: the first digest is always due
        self._last_report_mono: "Optional[float]" = None
        # first-K distinct frag ids keep their name as a metric label;
        # later ones fold into "other" (the worst-K cardinality tier)
        self._label_frags: "Dict[str, str]" = {}
        self._flightrec_ring = _flightrec.FlightRecorder(
            capacity=env_int("TORCHFT_FRAG_RING", _DEFAULT_RING, minimum=16)
        )
        self._holder = f"{socket.gethostname()}:{os.getpid()}"

    # -- configuration ----------------------------------------------------

    def reset(self) -> None:
        """Drop the vector + ring and re-read env knobs (tests flip
        them)."""
        with self._lock:
            self._vector.clear()
            self._dirty.clear()
            self._label_frags.clear()
            self._last_report_mono = None
            self._topk = env_int("TORCHFT_FRAG_TOPK", 16, minimum=1)
            self._report_s = env_float(
                "TORCHFT_FRAG_REPORT_S", 2.0, minimum=0.0
            )
            self._flightrec_ring = _flightrec.FlightRecorder(
                capacity=env_int(
                    "TORCHFT_FRAG_RING", _DEFAULT_RING, minimum=16
                )
            )
            self._holder = f"{socket.gethostname()}:{os.getpid()}"

    def set_holder(self, holder: str) -> None:
        """Override the holder identity stamped on ring records (defaults
        to ``host:pid``; tests and multi-role processes disambiguate)."""
        with self._lock:
            self._holder = holder

    # -- hot path ---------------------------------------------------------

    def note_hold(
        self,
        fid: str,
        version: int,
        digest: str = "",
        version_ms: int = 0,
        role: str = "holder",
        publisher: bool = False,
    ) -> None:
        """A holder staged/verified/spilled fragment ``fid`` at
        ``version``.  Updates the local version vector (newest version
        wins; an equal re-hold refreshes nothing) and appends a
        ``fragment.hold`` ring record so dumps carry the journey's
        endpoints too.  ``version_ms`` is the manifest publish stamp
        (publisher's clock), carried unmodified."""
        try:
            now_ms = int(time.time() * 1e3)
            d8 = str(digest)[:8]
            with self._lock:
                e = self._vector.get(fid)
                if e is None:
                    e = self._vector[fid] = _Held()
                if version < e.version:
                    return  # stale re-hold never regresses the vector
                changed = version > e.version or d8 != e.digest8
                e.version = int(version)
                e.digest8 = d8
                e.version_ms = int(version_ms)
                e.pub = e.pub or publisher
                if changed or e.held_since_ms == 0:
                    e.held_since_ms = now_ms
                    self._dirty.add(fid)
                holder = self._holder
            self._flightrec_ring.record(
                "fragment.hold",
                frag=fid,
                version=int(version),
                digest8=d8,
                version_ms=int(version_ms),
                holder=holder,
                role=role,
            )
        except Exception:  # noqa: BLE001 - provenance never fails a hold
            logger.debug("note_hold failed", exc_info=True)

    def note_hop(
        self,
        fid: str,
        version: int,
        source: str,
        plane: str,
        verdict: str = "ok",
        nbytes: int = 0,
        first_byte_ms: float = 0.0,
        start_ns: "Optional[int]" = None,
    ) -> None:
        """One fragment transfer completed (or was rejected): append the
        provenance record.  ~1 us on the ok path — one ring record + one
        bounded counter; the span joins the per-step trace only when a
        sampled trace context is live."""
        try:
            holder = self._holder
            self._flightrec_ring.record(
                "fragment.hop",
                status="ok" if verdict == "ok" else "error",
                start_ns=start_ns,
                frag=fid,
                version=int(version),
                source=source,
                plane=plane,
                verdict=verdict,
                bytes=int(nbytes),
                first_byte_ms=round(float(first_byte_ms), 3),
                holder=holder,
            )
            from torchft_tpu_torch.utils import metrics as _metrics

            _metrics.FRAG_HOPS.labels(plane=plane, verdict=verdict).inc()
            from torchft_tpu_torch.utils import tracing as _tracing

            tracer = _tracing.get_tracer()
            ctx = _tracing.get_current()
            if tracer is not None and ctx is not None and ctx.sampled:
                end_ns = time.time_ns()
                tracer.export_span(
                    name="fragment.hop",
                    trace_id=ctx.trace_id,
                    parent_span_id=ctx.span_id,
                    start_ns=start_ns if start_ns is not None else end_ns,
                    end_ns=end_ns,
                    attributes={
                        "frag": fid,
                        "version": int(version),
                        "source": source,
                        "plane": plane,
                        "verdict": verdict,
                        "bytes": int(nbytes),
                    },
                )
        except Exception:  # noqa: BLE001 - provenance never fails a hop
            logger.debug("note_hop failed", exc_info=True)

    # -- bounded metric labels (worst-K tier) -----------------------------

    def frag_topk_label(self, fid: str) -> str:
        """Bounded per-fragment metric label: the first
        ``TORCHFT_FRAG_TOPK`` distinct frag ids keep their name, later
        ones fold into ``other`` — at most K+1 values ever (frag ids are
        layout coordinates, restart-stable).  The ``metrics-cardinality``
        lint recognizes ``*topk_label`` accessors as this bounded tier."""
        with self._lock:
            label = self._label_frags.get(fid)
            if label is None:
                label = (
                    fid if len(self._label_frags) < self._topk else "other"
                )
                self._label_frags[fid] = label
            return label

    # -- snapshots / digest ------------------------------------------------

    def snapshot(self) -> "Dict[str, Dict[str, Any]]":
        """Copy of the local version vector, keyed by frag id."""
        with self._lock:
            return {fid: e.to_row(fid) for fid, e in self._vector.items()}

    def hop_records(self) -> "List[Dict[str, Any]]":
        """Completed hop/hold ring records, oldest first (tests/bench)."""
        return self._flightrec_ring.snapshot()

    def maybe_digest(self, host: str) -> "Optional[Dict[str, Any]]":
        """The heartbeat-piggyback digest, rate-limited to one per
        ``TORCHFT_FRAG_REPORT_S``: ``None`` when not due or empty.  Rows
        are bounded: the worst-K stalest stamped fragments (oldest
        ``version_ms`` first — the rows worth aggregating fleet-wide)
        plus everything that changed since the last report, hard-capped
        at 8*K.  The dirty set is CONSUMED here; on RPC failure the
        sender hands the digest back via :meth:`restore_digest`."""
        now = time.monotonic()
        with self._lock:
            if not self._vector:
                return None
            if (
                self._report_s > 0.0
                and self._last_report_mono is not None
                and now - self._last_report_mono < self._report_s
            ):
                return None
            self._last_report_mono = now
            entries = sorted(self._vector.items())
            dirty = set(self._dirty)
            self._dirty.clear()
            topk = self._topk
        stamped = [(fid, e) for fid, e in entries if e.version_ms > 0]
        stale = sorted(stamped, key=lambda kv: kv[1].version_ms)[:topk]
        chosen = {fid for fid, _ in stale} | dirty
        rows = [e.to_row(fid) for fid, e in entries if fid in chosen]
        rows = rows[: 8 * topk]
        self._export_metrics(entries, topk)
        if not rows:
            return None
        return {"host": host, "frags": rows}

    def restore_digest(self, digest: "Optional[Dict[str, Any]]") -> None:
        """A piggybacked digest failed to send: re-mark its rows dirty
        and lift the rate limit so the next beat re-reports (the
        consumed-on-send contract's failure leg)."""
        if not digest:
            return
        with self._lock:
            for row in digest.get("frags") or []:
                fid = row.get("frag")
                if fid in self._vector:
                    self._dirty.add(str(fid))
            self._last_report_mono = None

    def _export_metrics(
        self, entries: "List[Any]", topk: int
    ) -> None:
        """Refresh the worst-K-bounded ``torchft_frag_*`` gauges plus the
        unlabeled aggregates (cardinality contract: docs/observability.md
        "metric cardinality")."""
        try:
            from torchft_tpu_torch.utils import metrics as _metrics

            _metrics.FRAG_HELD.set(len(entries))
            now_ms = int(time.time() * 1e3)
            stamped = [
                (fid, e) for fid, e in entries if e.version_ms > 0
            ]
            _metrics.FRAG_STAMP_AGE_MAX.set(
                max(
                    (now_ms - e.version_ms for _, e in stamped),
                    default=0,
                )
                / 1e3
            )
            for fid, e in sorted(
                stamped, key=lambda kv: kv[1].version_ms
            )[:topk]:
                _metrics.FRAG_STAMP_AGE.labels(
                    frag=self.frag_topk_label(fid)
                ).set((now_ms - e.version_ms) / 1e3)
        except Exception:  # noqa: BLE001 - telemetry refresh never raises
            logger.debug("frag metric export failed", exc_info=True)

    # -- crash-durable dump ------------------------------------------------

    def dump(
        self,
        reason: str,
        trigger: str = "manual",
        path: "Optional[str]" = None,
        blocking: bool = True,
    ) -> "Optional[str]":
        """Dump the hop ring as JSONL — same format as the flight
        recorder, default sink ``TORCHFT_FLIGHT_FILE + ".prov"`` (the
        provenance evidence lands alongside the flight evidence)."""
        if path is None:
            base = _flightrec.dump_path()
            if base is None:
                return None
            path = base + ".prov"
        return self._flightrec_ring.dump(
            reason, trigger=trigger, path=path, blocking=blocking
        )


#: the process-wide registry every fragment plane feeds
PROV = ProvenanceRegistry()

# module-level shorthands (the form the production call sites use)
note_hold = PROV.note_hold
note_hop = PROV.note_hop


def _companion_dump(
    reason: str, trigger: str, blocking: bool, target: str
) -> None:
    # Ride every process-recorder dump: the same trigger (signal, abort,
    # manager error) that freezes the flight ring freezes the hop ring,
    # into <same path>.prov.
    PROV.dump(reason, trigger=trigger, path=target + ".prov",
              blocking=blocking)


_flightrec.register_companion_dump(_companion_dump)
