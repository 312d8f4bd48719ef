"""Structured event logging for quorums / commits / errors / aborts.

Analog of the reference's structured-event pipeline (reference:
torchft/otel.py:42-86 and manager.py:659-669,848-858).  The reference's
OTEL layer is an exporter *interface* (a Tee of console + OTLP sinks);
this module mirrors that shape: ``log_event`` fans every record out to a
registry of :class:`EventExporter` objects.  OTLP itself is out of scope
in a zero-egress environment, but the seam is what a deployment needs —
``register_exporter`` installs any custom sink without monkeypatching.

Built-in exporters:

- :class:`RingExporter` — in-memory ring of recent events the lighthouse
  dashboard and tests inspect (always installed; ``recent_events()``).
- :class:`JSONLFileExporter` — the crash-durable sink (an FT system's
  logs matter most when the process dies): set ``TORCHFT_EVENTS_FILE``
  to a path and every event is appended as one JSON line, flushed per
  event, with size-based rotation to ``<path>.1`` at
  ``TORCHFT_EVENTS_MAX_BYTES`` (default 16 MiB).  Auto-installed from
  the env var.

Every record additionally lands on stdlib logging with the extras
rendered inline (the reference's console leg of the Tee).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
from abc import ABC, abstractmethod
from typing import Any, Callable, Deque, Dict, List, Optional, TextIO

def _event_ring_size() -> int:
    """Ring capacity from ``TORCHFT_EVENTS_RING`` (default 256).  Read at
    import (the ring is a module singleton) — set the env before the first
    ``import torchft_tpu`` to size it."""
    from torchft_tpu_torch.utils.env import env_int

    return env_int("TORCHFT_EVENTS_RING", 256)


_EVENT_RING_SIZE = _event_ring_size()

_LOGGERS = {
    "quorum": logging.getLogger("torchft_quorums"),
    "commit": logging.getLogger("torchft_commits"),
    "error": logging.getLogger("torchft_errors"),
    "abort": logging.getLogger("torchft_aborts"),
    # telemetry-layer kinds: live checkpoint transfer and PG membership
    # reconfiguration (mirror _SEVERITY in utils/otel.py when extending)
    "heal": logging.getLogger("torchft_heals"),
    "reconfigure": logging.getLogger("torchft_reconfigures"),
    # chaos layer: every injected fault (utils/faults.py)
    "fault": logging.getLogger("torchft_faults"),
    # online parallelism switching: layout plans, reshard staging,
    # fleet-wide commit/rollback (parallel/layout.py)
    "layout": logging.getLogger("torchft_layouts"),
}

_lock = threading.Lock()


class EventExporter(ABC):
    """One sink in the event pipeline (reference otel.py:42-86 exporter
    shape).  ``export`` receives every structured record; exceptions are
    swallowed by the pipeline (a sink must never take down training) but
    logged.  ``close`` releases resources; an exporter may be registered
    and unregistered at runtime."""

    @abstractmethod
    def export(self, record: "Dict[str, Any]") -> None: ...

    def close(self) -> None:  # noqa: B027 - optional hook
        pass


class RingExporter(EventExporter):
    """Bounded in-memory ring of the most recent events.

    Internally locked: exports arrive from any thread (the pipeline calls
    exporters outside its own lock for re-entrancy) while readers snapshot
    — iterating a deque concurrently with appends raises RuntimeError."""

    def __init__(self, maxlen: int = _EVENT_RING_SIZE) -> None:
        self._events: "Deque[Dict[str, Any]]" = collections.deque(maxlen=maxlen)
        self._ring_lock = threading.Lock()

    def export(self, record: "Dict[str, Any]") -> None:
        with self._ring_lock:
            self._events.append(record)

    def events(self) -> "List[Dict[str, Any]]":
        with self._ring_lock:
            return list(self._events)

    def clear(self) -> None:
        with self._ring_lock:
            self._events.clear()


class CallbackExporter(EventExporter):
    """Adapter: wrap a plain callable as an exporter (the cheapest way for
    user code to tap the event stream)."""

    def __init__(self, fn: "Callable[[Dict[str, Any]], None]") -> None:
        self._fn = fn

    def export(self, record: "Dict[str, Any]") -> None:
        self._fn(record)


class JSONLFileExporter(EventExporter):
    """Append-per-event JSONL writer with size-based rotation.

    Flushes after every event: a SIGKILLed replica must leave its last
    quorum/commit/error on disk (reference's OTLP exporter flushes per
    batch for the same reason, torchft/otel.py:42-86).
    """

    def __init__(self, path: str, max_bytes: int = 16 * 1024 * 1024) -> None:
        self._path = path
        self._max_bytes = max_bytes
        self._fh: "Optional[TextIO]" = None
        # exports may arrive from multiple threads (the pipeline calls
        # exporters outside its own lock to allow re-entrancy)
        self._write_lock = threading.Lock()

    def export(self, record: "Dict[str, Any]") -> None:
        with self._write_lock:
            self._export_locked(record)

    def _export_locked(self, record: "Dict[str, Any]") -> None:
        try:
            if self._fh is None:
                self._fh = open(self._path, "a", encoding="utf-8")
            elif self._stale():
                # another process rotated the shared file out from under us
                # (WatchedFileHandler pattern): reopen before writing so we
                # never keep appending to the rotated inode
                self._fh.close()
                self._fh = open(self._path, "a", encoding="utf-8")
            if self._fh.tell() > self._max_bytes:
                self._fh.close()
                self._fh = None
                # racing rotators: os.replace is atomic, and the loser's
                # reopen lands on the fresh file via the _stale() check
                os.replace(self._path, self._path + ".1")
                self._fh = open(self._path, "a", encoding="utf-8")
            json.dump(record, self._fh, default=str)
            self._fh.write("\n")
            self._fh.flush()
        except OSError as e:  # never take down training for a log sink
            logging.getLogger(__name__).warning(
                "event file write failed (%s): %s", self._path, e
            )

    def _stale(self) -> bool:
        assert self._fh is not None
        try:
            disk = os.stat(self._path)
        except FileNotFoundError:
            return True
        ours = os.fstat(self._fh.fileno())
        return (disk.st_ino, disk.st_dev) != (ours.st_ino, ours.st_dev)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# --- exporter registry ------------------------------------------------------

_ring = RingExporter()
_registered: "List[EventExporter]" = []
_env_exporter: "Optional[JSONLFileExporter]" = None
_env_exporter_path: "Optional[str]" = None  # env value it was built for


def register_exporter(exporter: EventExporter) -> EventExporter:
    """Install an exporter into the pipeline; returns it (for later
    :func:`unregister_exporter`).  No monkeypatching required."""
    with _lock:
        _registered.append(exporter)
    return exporter


def unregister_exporter(exporter: EventExporter) -> None:
    """Remove (and close) a previously registered exporter."""
    with _lock:
        if exporter in _registered:
            _registered.remove(exporter)
    exporter.close()


def _env_jsonl_exporter() -> "Optional[JSONLFileExporter]":
    """Resolve the JSONL exporter from ``TORCHFT_EVENTS_FILE`` (re-resolved
    when the env value changes, so tests and launchers can redirect)."""
    from torchft_tpu_torch.utils.env import env_int, env_str

    global _env_exporter, _env_exporter_path
    path = env_str("TORCHFT_EVENTS_FILE") or None
    if path != _env_exporter_path:
        if _env_exporter is not None:
            _env_exporter.close()
        _env_exporter = (
            JSONLFileExporter(
                path,
                env_int("TORCHFT_EVENTS_MAX_BYTES", 16 * 1024 * 1024, minimum=0),
            )
            if path
            else None
        )
        _env_exporter_path = path
    return _env_exporter


def log_event(kind: str, message: str, **extra: Any) -> None:
    """Record a structured protocol event
    (kind in {quorum, commit, error, abort, heal, reconfigure})."""
    if kind not in _LOGGERS:
        raise ValueError(f"unknown event kind {kind!r}, expected one of {sorted(_LOGGERS)}")
    record = {"ts": time.time(), "kind": kind, "message": message, **extra}
    # Snapshot the sink list under the lock, but call export() OUTSIDE it:
    # a custom exporter is allowed to re-enter this module (recent_events,
    # even log_event) without deadlocking.  Each exporter handles its own
    # thread safety (JSONLFileExporter serializes internally; the ring's
    # deque append is atomic).
    with _lock:
        sinks: "List[EventExporter]" = [_ring]
        env = _env_jsonl_exporter()
        if env is not None:
            sinks.append(env)
        sinks.extend(_registered)
    for sink in sinks:
        try:
            sink.export(record)
        except Exception as e:  # noqa: BLE001 - a sink never kills training
            logging.getLogger(__name__).warning(
                "event exporter %r failed: %s", type(sink).__name__, e
            )
    logger = _LOGGERS[kind]
    rendered = " ".join(f"{k}={v}" for k, v in extra.items())
    if kind in ("error", "abort"):
        logger.error("%s %s", message, rendered)
    else:
        logger.info("%s %s", message, rendered)


def recent_events() -> "list[Dict[str, Any]]":
    with _lock:
        return _ring.events()


class ReplicaLogger:
    """Prefixes log lines with ``[replica_id/rank - step N]``.

    Analog of reference torchft/manager.py:991-1008.
    """

    def __init__(self, manager: Any, replica_id: str, rank: int) -> None:
        self._logger = logging.getLogger("torchft_tpu_torch.manager")
        self._manager = manager
        self._replica_id = replica_id
        self._rank = rank

    def _prefix(self) -> str:
        return f"[{self._replica_id}/{self._rank} - step {self._manager.current_step()}]"

    def info(self, msg: str) -> None:
        self._logger.info("%s %s", self._prefix(), msg)

    def warning(self, msg: str) -> None:
        self._logger.warning("%s %s", self._prefix(), msg)

    def exception(self, msg: str) -> None:
        self._logger.exception("%s %s", self._prefix(), msg)
