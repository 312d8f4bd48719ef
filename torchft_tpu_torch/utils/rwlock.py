"""Readers-writer lock with timeout-guarded acquisition.

TPU-native analog of the reference's checkpoint RWLock
(reference: torchft/checkpointing/_rwlock.py:41-131): many readers may hold
the lock concurrently (e.g. checkpoint transports serving a state snapshot)
while a single writer (the optimizer step mutating parameters) excludes all
readers.  Every acquisition takes a timeout so a stuck peer can never wedge
the training loop forever.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Iterator

from torchft_tpu_torch.utils import lockcheck


class RWLock:
    """A two-mutex readers-writer lock.

    Writer preference is not enforced; fairness comes from the underlying
    primitive. All acquires raise TimeoutError on expiry rather than blocking
    forever, which is the property the fault-tolerance protocol needs.

    Not reentrant: a thread already holding the read side must not take
    the write side (upgrade deadlocks by construction), and a reader
    re-entering ``acquire_read`` while a writer waits can deadlock on
    primitives with writer preference.  Under ``TORCHFT_LOCKCHECK=1``
    both mutexes are lockcheck-instrumented: the reader gate as a full
    order-graph participant, the writer side as a hold-time-only *gate*
    (community-held, released cross-thread — order analysis would report
    a false reader<->writer cycle for it; see lockcheck.gate()).
    """

    def __init__(self, timeout: float = -1, writer_priority: bool = False) -> None:
        # Default timeout applied when an acquire doesn't pass its own.
        self._default_timeout = timeout
        self._reader_lock = lockcheck.lock("rwlock.reader_gate")
        # community gate: taken by the FIRST reader, released by the LAST
        # (possibly a different thread) — order-graph analysis is
        # thread-local and would report a false reader<->writer cycle, so
        # it gets hold-time-only instrumentation
        self._writer_lock = lockcheck.gate("rwlock.writer_gate")
        self._readers = 0
        # Writer-priority turnstile (opt-in).  The plain lock is
        # reader-preferring: with continuously overlapping readers,
        # ``_readers`` never reaches 0 and a writer starves FOREVER —
        # measured in the serving soak, where 32 polling clients held the
        # staged-snapshot read side so densely that a relay's staging
        # write lock never acquired and the whole tier 503'd.  With
        # ``writer_priority``, a waiting writer holds the turnstile while
        # it waits, new readers must pass through it first, the existing
        # readers drain, and the writer gets in; readers resume after.
        # Sharpens the documented non-reentrancy rule: under
        # writer_priority a reader RE-entering acquire_read while a
        # writer waits deadlocks by construction — don't nest readers.
        self._writer_priority = writer_priority
        self._turnstile = (
            lockcheck.lock("rwlock.turnstile") if writer_priority else None
        )

    def _resolve(self, timeout: float | None) -> float:
        return self._default_timeout if timeout is None else timeout

    def acquire_read(self, timeout: float | None = None) -> None:
        t = self._resolve(timeout)
        # Single deadline across both mutex acquisitions so the configured
        # timeout bounds the total wait, not each stage.
        deadline = time.monotonic() + t if t >= 0 else None
        if self._turnstile is not None:
            # Writer-priority: pass through the turnstile a waiting
            # writer holds, so new readers queue BEHIND the writer
            # instead of starving it (acquire-and-release: readers never
            # hold it while waiting on the gates below).
            if not self._turnstile.acquire(timeout=t):
                raise TimeoutError(f"acquire_read timed out after {t}s")
            self._turnstile.release()
            if deadline is not None:
                t = max(0.0, deadline - time.monotonic())
        if not self._reader_lock.acquire(timeout=t):
            raise TimeoutError(f"acquire_read timed out after {t}s")
        try:
            self._readers += 1
            if self._readers == 1:
                # First reader takes the writer lock on behalf of all readers.
                remaining = t if deadline is None else max(0.0, deadline - time.monotonic())
                if not self._writer_lock.acquire(timeout=remaining):
                    self._readers -= 1
                    raise TimeoutError(f"acquire_read timed out after {t}s")
        finally:
            self._reader_lock.release()

    def release_read(self) -> None:
        with self._reader_lock:
            assert self._readers > 0, "release_read without acquire_read"
            self._readers -= 1
            if self._readers == 0:
                self._writer_lock.release()

    def acquire_write(self, timeout: float | None = None) -> None:
        t = self._resolve(timeout)
        if self._turnstile is None:
            if not self._writer_lock.acquire(timeout=t):
                raise TimeoutError(f"acquire_write timed out after {t}s")
            return
        # Writer-priority: hold the turnstile while waiting on the
        # writer gate — new readers block at the turnstile, the readers
        # already in drain, and the writer acquires in bounded time
        # regardless of reader arrival rate.
        deadline = time.monotonic() + t if t >= 0 else None
        if not self._turnstile.acquire(timeout=t):
            raise TimeoutError(f"acquire_write timed out after {t}s")
        try:
            remaining = (
                t if deadline is None else max(0.0, deadline - time.monotonic())
            )
            if not self._writer_lock.acquire(timeout=remaining):
                raise TimeoutError(f"acquire_write timed out after {t}s")
        finally:
            self._turnstile.release()

    def release_write(self) -> None:
        self._writer_lock.release()

    @contextmanager
    def r_lock(self, timeout: float | None = None) -> Iterator[None]:
        self.acquire_read(timeout)
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def w_lock(self, timeout: float | None = None) -> Iterator[None]:
        self.acquire_write(timeout)
        try:
            yield
        finally:
            self.release_write()
