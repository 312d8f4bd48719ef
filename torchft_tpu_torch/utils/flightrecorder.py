"""Per-process flight recorder: the blackbox a postmortem replays.

torchft_tpu's whole value is surviving per-step failures, but a failure
that *degrades* a run is diagnosed from whatever the dying/wedged process
left behind.  Before this module that evidence was fragmented: a one-off
``_flight`` dict inside ``ProcessGroupTCP`` (dumped only as a log event),
the event ring, and per-signal metrics.  Both Prime's PCCL report and
"Reliable and Resilient Collective Communication Library for LLM Training
and Serving" (PAPERS.md) treat the in-flight-op blackbox as a first-class
subsystem of a fault-tolerant collective stack — this module is that
subsystem:

- a **lock-cheap ring** of structured records (``op``, ``status``,
  ``start_ns``/``end_ns``, plus whatever context the site supplies:
  ``step``, ``quorum_id``, ``replica_id``, ``attempt``, ``fault``,
  transfer bytes/peers).  Hot-path budget: ~2 us per :func:`record`
  (same bar as the metrics layer's ``observe``), enforced by a unit
  test;
- **in-flight op tracking** (:meth:`FlightRecorder.start` →
  :class:`FlightOp`): the op a thread is *currently blocked inside* is
  exactly what a wedged-collective postmortem needs; open ops appear in
  every snapshot/dump with ``status="inflight"``.  This subsumes the old
  ``ProcessGroupTCP._flight`` dict;
- a **crash-durable dump**: :func:`dump` appends a meta line plus the
  full ring snapshot as JSONL to ``TORCHFT_FLIGHT_FILE``, fsync-free but
  flushed, so a SIGKILL one instruction later still leaves the file
  parseable.  Triggers wired through the stack: process-group abort and
  collective failure (parallel/process_group.py), unhandled manager
  errors (manager.py ``report_error``), fatal signals
  (SIGTERM/SIGABRT, installed when ``TORCHFT_FLIGHT_FILE`` is set), and
  on demand.  Each written dump increments
  ``torchft_flight_dumps_total{trigger}``.

``python -m torchft_tpu_torch.diagnose`` merges N replicas' dumps (plus
``TORCHFT_EVENTS_FILE`` logs) into one cross-replica timeline and flags
the likely culprit — see docs/observability.md "post-mortem workflow".

Env knobs: ``TORCHFT_FLIGHT_FILE`` (dump path; unset = dumps are no-ops),
``TORCHFT_FLIGHT_RING`` (ring capacity, default 512),
``TORCHFT_FLIGHT_MAX_BYTES`` (rotate the dump file to ``<path>.1`` past
this size, default 64 MiB).

Failure policy matches every telemetry surface in this package: the
recorder must never take down (or mask an error in) training — dump
failures log and return ``None``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import signal
import time
from typing import Any, Dict, Iterator, List, Optional

from torchft_tpu_torch.utils import lockcheck
from torchft_tpu_torch.utils.env import env_int, env_str

logger = logging.getLogger(__name__)

__all__ = [
    "env_int",  # re-export: moved to utils/env.py (PR 4), kept for compat
    "FlightOp",
    "FlightRecorder",
    "RECORDER",
    "record",
    "start",
    "track",
    "snapshot",
    "dump",
    "dump_path",
    "install_signal_hooks",
    "register_companion_dump",
]

_DEFAULT_RING = 512


def _ring_capacity() -> int:
    return env_int("TORCHFT_FLIGHT_RING", _DEFAULT_RING)


class FlightOp:
    """Handle for one in-flight operation.

    Created by :meth:`FlightRecorder.start`; the owning thread (and any
    helper threads, e.g. a PG's sender thread) call :meth:`update` /
    :meth:`add_bytes` as the transfer progresses, then exactly one caller
    :meth:`finish`\\ es it — writing the completed record into the ring.
    All methods are thread-safe and idempotent-on-finish (a double finish
    is a no-op returning the already-finished record).
    """

    __slots__ = ("_recorder", "_fields", "_lock", "_done")

    def __init__(self, recorder: "FlightRecorder", fields: "Dict[str, Any]") -> None:
        self._recorder = recorder
        self._fields = fields
        self._lock = lockcheck.lock("flightrecorder.flight_op")
        self._done = False

    def update(self, **fields: Any) -> None:
        """Merge transfer state (peer, tag, bytes, deadline...) into the op."""
        with self._lock:
            if not self._done:
                self._fields.update(fields)

    def add_bytes(self, nbytes: int) -> None:
        """Accumulate transfer progress into ``bytes_done``."""
        with self._lock:
            if not self._done:
                f = self._fields
                f["bytes_done"] = f.get("bytes_done", 0) + nbytes

    def finish(self, status: str = "ok", **fields: Any) -> "Dict[str, Any]":
        """Complete the op: stamp ``end_ns``/``status``, move the record
        from the open set into the ring.  Returns the completed record."""
        with self._lock:
            if self._done:
                return dict(self._fields)
            self._done = True
            self._fields.update(fields)
            self._fields["status"] = status
            self._fields["end_ns"] = time.time_ns()
            rec = dict(self._fields)
        self._recorder._complete(self, rec)
        return rec

    def snapshot(self, blocking: bool = True) -> "Optional[Dict[str, Any]]":
        """Copy of the op's fields; with ``blocking=False`` (the
        signal-handler path) returns None instead of risking a deadlock
        on a lock the interrupted thread holds."""
        if blocking:
            self._lock.acquire()
        elif not self._lock.acquire(timeout=0.05):
            return None
        try:
            return dict(self._fields)
        finally:
            self._lock.release()


class FlightRecorder:
    """Bounded ring of structured flight records + open-op registry."""

    def __init__(self, capacity: "Optional[int]" = None) -> None:
        cap = capacity if capacity is not None else _ring_capacity()
        self._cap = max(int(cap), 1)
        self._ring: "List[Optional[Dict[str, Any]]]" = [None] * self._cap
        self._idx = 0  # total records ever written (monotone)
        self._lock = lockcheck.lock("flightrecorder.ring")
        self._open: "Dict[int, FlightOp]" = {}
        self._dump_lock = lockcheck.lock("flightrecorder.dump")

    # -- hot path ----------------------------------------------------------

    def record(
        self,
        op: str,
        status: str = "ok",
        start_ns: "Optional[int]" = None,
        end_ns: "Optional[int]" = None,
        **fields: Any,
    ) -> None:
        """Append one completed record.  ~1 us: one dict build, one lock,
        one slot assignment — safe on the allreduce hot path."""
        now = time.time_ns()
        rec = {
            "op": op,
            "status": status,
            "start_ns": start_ns if start_ns is not None else now,
            "end_ns": end_ns if end_ns is not None else now,
            **fields,
        }
        with self._lock:
            self._ring[self._idx % self._cap] = rec
            self._idx += 1

    # -- in-flight ops -----------------------------------------------------

    def start(self, op: str, **fields: Any) -> FlightOp:
        """Open an in-flight op; it appears in snapshots/dumps as
        ``status="inflight"`` until :meth:`FlightOp.finish`."""
        rec = {"op": op, "status": "inflight", "start_ns": time.time_ns(), **fields}
        handle = FlightOp(self, rec)
        with self._lock:
            self._open[id(handle)] = handle
        return handle

    def _complete(self, handle: FlightOp, rec: "Dict[str, Any]") -> None:
        with self._lock:
            self._open.pop(id(handle), None)
            self._ring[self._idx % self._cap] = rec
            self._idx += 1

    # -- introspection -----------------------------------------------------

    def snapshot(self, blocking: bool = True) -> "List[Dict[str, Any]]":
        """Completed records (oldest first) followed by open ops.

        ``blocking=False`` is the signal-handler path: the handler runs ON
        the interrupted thread, which may be holding ``self._lock`` inside
        ``record()`` — a blocking acquire there would self-deadlock the
        dying process.  Try briefly, then read unlocked: ring slots are
        replaced wholesale (a read sees the old or new dict, never a torn
        one), which is exactly good enough for a last-gasp dump."""
        if blocking:
            self._lock.acquire()
            acquired = True
        else:
            acquired = self._lock.acquire(timeout=0.25)
        try:
            idx, cap = self._idx, self._cap
            if idx <= cap:
                ring = [r for r in self._ring[:idx] if r is not None]
            else:
                cut = idx % cap
                ring = [
                    r for r in self._ring[cut:] + self._ring[:cut] if r is not None
                ]
            open_ops = list(self._open.values())
        finally:
            if acquired:
                self._lock.release()
        out = [dict(r) for r in ring]
        for o in open_ops:
            snap = o.snapshot(blocking=blocking)
            if snap is not None:
                out.append(snap)
        return out

    def total_recorded(self) -> int:
        with self._lock:
            return self._idx

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self._cap
            self._idx = 0
            self._open.clear()

    # -- crash-durable dump ------------------------------------------------

    def dump(
        self,
        reason: str,
        trigger: str = "manual",
        path: "Optional[str]" = None,
        blocking: bool = True,
    ) -> "Optional[str]":
        """Append a dump (meta line + ring snapshot, one JSON object per
        line) to ``path`` or ``TORCHFT_FLIGHT_FILE``.  Returns the path
        written, or None when no sink is configured / the write failed —
        never raises (the recorder must never mask the error that
        triggered it).  ``blocking=False`` is for signal handlers: every
        lock is acquired with a short timeout so a handler running on a
        thread that already holds one cannot self-deadlock."""
        target = path or env_str("TORCHFT_FLIGHT_FILE") or None
        if target is None:
            return None
        records = self.snapshot(blocking=blocking)
        meta = {
            "flight": "meta",
            "reason": reason,
            "trigger": trigger,
            "ts": time.time(),
            "pid": os.getpid(),
            "records": len(records),
        }
        if blocking:
            self._dump_lock.acquire()
            have_dump_lock = True
        else:
            # best effort: a torn interleaved dump beats a wedged death
            have_dump_lock = self._dump_lock.acquire(timeout=0.25)
        try:
            # Size-based rotation (same policy as the events sink): a run
            # flapping for hours writes one full-ring snapshot per
            # trigger, and an unbounded append could fill the disk out
            # from under training.
            try:
                if os.path.getsize(target) > env_int(
                    "TORCHFT_FLIGHT_MAX_BYTES", 64 * 1024 * 1024, minimum=4096
                ):
                    os.replace(target, target + ".1")
            except OSError:
                pass  # missing file / rotation race: append below anyway
            with open(target, "a", encoding="utf-8") as fh:
                fh.write(json.dumps(meta, default=str) + "\n")
                for rec in records:
                    fh.write(
                        json.dumps({"flight": "rec", **rec}, default=str) + "\n"
                    )
                fh.flush()
        except OSError as e:
            logger.warning("flight dump to %s failed: %s", target, e)
            return None
        finally:
            if have_dump_lock:
                self._dump_lock.release()
        try:
            from torchft_tpu_torch.utils import metrics as _metrics

            _metrics.FLIGHT_DUMPS.labels(trigger=trigger).inc()
        except Exception:  # noqa: BLE001 - accounting never masks the dump
            logger.exception("flight dump metric failed")
        # Companion rings (e.g. the fragment-provenance hop ring) dump
        # alongside every PROCESS-recorder dump so one trigger — signal,
        # abort, manager error — leaves the whole postmortem evidence set
        # next to each other on disk.  Private recorders don't cascade.
        if self is RECORDER:
            for fn in list(_companion_dumps):
                try:
                    fn(reason, trigger, blocking, target)
                except Exception:  # noqa: BLE001 - companions never mask
                    logger.exception("companion flight dump failed")
        return target


#: Callables ``fn(reason, trigger, blocking, target)`` fired after every
#: successful dump of the process-wide ``RECORDER`` (never of private
#: rings) — subsystems with their own bounded rings register here so a
#: crash dump carries their evidence too (checkpointing/provenance.py).
_companion_dumps: "List[Any]" = []


def register_companion_dump(fn: Any) -> None:
    """Register a companion dump hook (idempotent)."""
    if fn not in _companion_dumps:
        _companion_dumps.append(fn)


#: The process-wide recorder every production site feeds.
RECORDER = FlightRecorder()

# module-level shorthands (the form the production call sites use)
record = RECORDER.record
start = RECORDER.start
snapshot = RECORDER.snapshot
dump = RECORDER.dump


@contextlib.contextmanager
def track(op: str, **fields: Any) -> "Iterator[FlightOp]":
    """Scope an in-flight op: finish ``ok`` on normal exit, ``error``
    (with the exception's repr) when the body raises.  The yielded
    :class:`FlightOp` takes mid-flight ``update``/``add_bytes`` calls."""
    flight = RECORDER.start(op, **fields)
    try:
        yield flight
    except BaseException as e:
        flight.finish("error", error=repr(e))
        raise
    flight.finish("ok")


def dump_path() -> "Optional[str]":
    """The configured dump sink, or None (dumps are then no-ops)."""
    return env_str("TORCHFT_FLIGHT_FILE") or None


# ---------------------------------------------------------------------------
# fatal-signal hook
# ---------------------------------------------------------------------------

_prev_handlers: "Dict[int, Any]" = {}
_hooks_installed = False


def _on_fatal_signal(signum: int, frame: Any) -> None:
    # Non-blocking: the handler runs ON the interrupted thread, which may
    # hold a recorder lock mid-record — a blocking dump would swallow the
    # signal and wedge the process instead of letting it die.
    RECORDER.dump(f"fatal signal {signum}", trigger="signal", blocking=False)
    prev = _prev_handlers.get(signum)
    if prev is signal.SIG_IGN:
        return  # the process deliberately ignores this signal; keep doing so
    if callable(prev):
        prev(signum, frame)
    else:
        # SIG_DFL / unknown: restore the default disposition and re-deliver
        # so the process still dies with the signal's semantics (exit code,
        # core dump)
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)


def install_signal_hooks(signals: "Optional[List[int]]" = None) -> bool:
    """Dump the flight ring on fatal signals (SIGTERM/SIGABRT by default),
    then chain to the previous handler (or re-deliver the default).  Only
    installable from the main thread; returns True when installed."""
    global _hooks_installed
    if _hooks_installed:
        return True
    sigs = signals if signals is not None else [signal.SIGTERM, signal.SIGABRT]
    try:
        for s in sigs:
            _prev_handlers[s] = signal.signal(s, _on_fatal_signal)
    except ValueError:
        # not the main thread: the embedding process owns signal dispatch
        return False
    _hooks_installed = True
    return True


# A process that configures a dump sink wants the signal legs armed too:
# SIGTERM is how schedulers kill replicas, and the dying flight ring is
# exactly the evidence torchft-torch-diagnose needs.
if env_str("TORCHFT_FLIGHT_FILE"):
    install_signal_hooks()
