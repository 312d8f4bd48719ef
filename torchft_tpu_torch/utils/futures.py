"""Timeout engine: deadline-armed futures, context timeouts, and a watchdog.

TPU-native analog of the reference timeout/futures machinery
(reference: torchft/futures.py:45-315).  The reference wraps torch Futures and
CUDA events; here the unit of async work is a ``concurrent.futures.Future``
(JAX dispatch is asynchronous on its own — device-side completion is observed
with ``jax.block_until_ready`` at the points the protocol requires).

A single daemon timer thread owns a heap of deadlines.  A separate watchdog
thread kills the process (``sys.exit(1)``) if the timer thread itself stops
making progress for ``TORCHFT_WATCHDOG_TIMEOUT_SEC`` (default 30s) — a stuck
timeout engine means timeouts no longer fire, which in a fault-tolerance
system is itself a fault.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import os
import sys
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeoutError
from contextlib import contextmanager
from datetime import timedelta
from typing import Callable, Iterator, Optional, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")

from torchft_tpu_torch.utils.env import env_float

WATCHDOG_TIMEOUT_SEC = env_float("TORCHFT_WATCHDOG_TIMEOUT_SEC", 30.0)


def _to_seconds(timeout: "float | timedelta") -> float:
    if isinstance(timeout, timedelta):
        return timeout.total_seconds()
    return float(timeout)


def _noop() -> None:
    pass


class _Timer:
    __slots__ = ("deadline", "seq", "callback", "cancelled")

    def __init__(self, deadline: float, seq: int, callback: Callable[[], None]) -> None:
        self.deadline = deadline
        self.seq = seq
        self.callback = callback
        self.cancelled = False

    def __lt__(self, other: "_Timer") -> bool:
        return (self.deadline, self.seq) < (other.deadline, other.seq)


class _TimerHandle:
    def __init__(self, manager: "_TimeoutManager", timer: _Timer) -> None:
        self._manager = manager
        self._timer = timer

    def cancel(self) -> None:
        self._timer.cancelled = True
        # A cancelled timer waits in the heap until it surfaces; its
        # callback's closure holds the mirrored future and so the result
        # (a collective's arrays) for the whole timeout unless dropped now.
        self._timer.callback = _noop
        # Only wake the timer thread when this timer is the heap head (it may
        # be sleeping until exactly this deadline); cancelled non-head timers
        # are lazily dropped when they surface.
        mgr = self._manager
        with mgr._cond:
            if mgr._heap and mgr._heap[0] is self._timer:
                mgr._cond.notify()


class _TimeoutManager:
    """Singleton timer-heap thread plus stuck-loop watchdog."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._heap: list[_Timer] = []
        self._seq = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._watchdog: Optional[threading.Thread] = None
        # Monotonic tick the timer thread bumps each loop; watchdog checks it.
        self._last_tick = time.monotonic()

    def _ensure_started(self) -> None:
        with self._cond:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="torchft_timeout", daemon=True
                )
                self._thread.start()
                self._watchdog = threading.Thread(
                    target=self._run_watchdog, name="torchft_watchdog", daemon=True
                )
                self._watchdog.start()

    def schedule(self, timeout_sec: float, callback: Callable[[], None]) -> _TimerHandle:
        self._ensure_started()
        timer = _Timer(time.monotonic() + timeout_sec, next(self._seq), callback)
        with self._cond:
            heapq.heappush(self._heap, timer)
            self._cond.notify()
        return _TimerHandle(self, timer)

    def _run(self) -> None:
        while True:
            due: list[_Timer] = []
            with self._cond:
                now = time.monotonic()
                self._last_tick = now
                while self._heap and (
                    self._heap[0].cancelled or self._heap[0].deadline <= now
                ):
                    timer = heapq.heappop(self._heap)
                    if not timer.cancelled:
                        due.append(timer)
                if not due:
                    wait = (
                        self._heap[0].deadline - now if self._heap else None
                    )
                    self._cond.wait(timeout=wait)
            for timer in due:
                # Re-check: cancel() may have run after the pop. A callback
                # already executing can't be stopped — cancel is best-effort
                # once the deadline has passed.
                if timer.cancelled:
                    continue
                try:
                    timer.callback()
                except Exception:
                    logger.exception("timeout callback raised")

    def _run_watchdog(self) -> None:
        # The timer thread refreshes _last_tick whenever it wakes. If there is
        # pending work whose deadline has long passed and the tick is stale,
        # the loop is wedged (e.g. a callback deadlocked) — abort the process
        # so the job supervisor can restart this replica.
        while True:
            time.sleep(WATCHDOG_TIMEOUT_SEC / 4)
            with self._cond:
                stale = time.monotonic() - self._last_tick
                overdue = (
                    self._heap
                    and self._heap[0].deadline < time.monotonic() - WATCHDOG_TIMEOUT_SEC
                )
            if overdue and stale > WATCHDOG_TIMEOUT_SEC:
                logger.error(
                    "torchft timeout engine stuck for %.0fs — exiting process", stale
                )
                sys.stderr.write("torchft_tpu watchdog: timeout engine stuck, exiting\n")
                sys.stderr.flush()
                os._exit(1)


_TIMEOUT_MANAGER = _TimeoutManager()


def future_timeout(fut: "Future[T]", timeout: "float | timedelta") -> "Future[T]":
    """Return a future mirroring ``fut`` that fails with TimeoutError on expiry."""
    out: Future[T] = Future()

    def _expire() -> None:
        try:
            out.set_exception(TimeoutError(f"future timed out after {timeout}"))
        except Exception:
            pass  # lost the race with _copy

    handle = _TIMEOUT_MANAGER.schedule(_to_seconds(timeout), _expire)

    def _copy(f: "Future[T]") -> None:
        handle.cancel()
        try:
            if f.cancelled():
                out.cancel()
                return
            exc = f.exception()
            if exc is not None:
                out.set_exception(exc)
            else:
                out.set_result(f.result())
        except Exception:
            pass  # lost the race with the timeout callback

    fut.add_done_callback(_copy)
    return out


def future_wait(fut: "Future[T]", timeout: "float | timedelta") -> T:
    """Block on ``fut`` for at most ``timeout``; raises TimeoutError."""
    try:
        return fut.result(timeout=_to_seconds(timeout))
    except (TimeoutError, FuturesTimeoutError):
        # concurrent.futures.TimeoutError is only an alias of the builtin
        # from Python 3.11; on 3.10 result() raises the distinct class.
        # A future may legitimately complete *with* a TimeoutError (e.g. one
        # produced by future_timeout) — re-raise that as-is rather than
        # misreporting it as this wait expiring.
        if fut.done():
            raise
        raise TimeoutError(f"future did not complete within {timeout}")


@contextmanager
def context_timeout(
    callback: Callable[[], None], timeout: "float | timedelta"
) -> Iterator[None]:
    """Run ``callback`` (e.g. ``pg.abort``) if the with-block outlives the deadline."""
    handle = _TIMEOUT_MANAGER.schedule(_to_seconds(timeout), callback)
    try:
        yield
    finally:
        handle.cancel()
