"""Runtime lock-order cycle detector and hold-time profiler.

The static ``lock-discipline`` pass of ``tft-lint`` catches *blocking
calls under a lock*; what it cannot see is **acquisition order** — the
classic deadlock where thread 1 takes A then B while thread 2 takes B
then A.  With 80+ lock sites across the telemetry, chaos, and collective
layers, ordering discipline has to be checked by the running system, the
same stance TSan's deadlock detector takes for the C++ core
(``make -C native SANITIZE=thread``).  This module is the Python half:

- :func:`lock` / :func:`rlock` are drop-in factories the instrumented
  modules (flightrecorder, metrics, faults, rwlock, process_group) use in
  place of ``threading.Lock()`` / ``threading.RLock()``.  With
  ``TORCHFT_LOCKCHECK`` unset they return the plain ``threading``
  primitive — zero overhead, zero behavior change;
- with ``TORCHFT_LOCKCHECK=1`` they return a :class:`CheckedLock`
  wrapper that maintains a per-thread stack of held locks and a global
  **acquisition-order graph** keyed by lock *name* (one name per creation
  site, so instances aggregate like a metric family).  Each time a thread
  holding ``A`` acquires ``B``, the edge ``A -> B`` is recorded; a new
  edge that closes a cycle is a potential deadlock, reported once per
  distinct cycle via ``torchft_lock_cycles_total{edge}``, an ERROR log
  line, and :func:`cycles` (tests assert on it; production alerts on
  the counter);
- releases longer than ``TORCHFT_LOCKCHECK_HOLD_MS`` (default 250 ms)
  after acquisition count as **hold-time outliers**
  (``torchft_lock_hold_outliers_total{name}``) — a long-held lock in a
  per-step FT protocol is where stragglers are born.

Cross-thread release (legal on ``threading.Lock``, and used by
``utils/rwlock.py`` where the *last* reader releases the writer gate the
*first* reader took) is handled: a release that doesn't match the
releasing thread's stack is simply untracked.

The detector's own bookkeeping uses a raw ``threading.Lock`` plus a
thread-local reentrancy guard, so reporting through the (itself
instrumented) metrics registry cannot recurse or self-deadlock.

Enable for a test run::

    TORCHFT_LOCKCHECK=1 pytest -m 'not slow'

(tests/conftest.py sets it by default, so the tier-1 suite always runs
instrumented; export ``TORCHFT_LOCKCHECK=0`` to opt out.)
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from torchft_tpu_torch.utils.env import env_bool, env_float

logger = logging.getLogger(__name__)

__all__ = [
    "lock",
    "rlock",
    "gate",
    "CheckedLock",
    "enabled",
    "set_enabled",
    "cycles",
    "edges",
    "reset",
    "hold_outliers",
]

# Read once at import; set_enabled() overrides (tests, embedding apps).
_enabled = env_bool("TORCHFT_LOCKCHECK")


def _hold_threshold_s() -> float:
    return env_float("TORCHFT_LOCKCHECK_HOLD_MS", 250.0, minimum=0.0) / 1000.0


class _Graph:
    """Global acquisition-order graph + reports (process-wide singleton)."""

    def __init__(self) -> None:
        self._mu = threading.Lock()  # raw on purpose: never instrumented
        self._edges: "Dict[str, Set[str]]" = {}
        self._cycles: "List[Tuple[str, ...]]" = []
        self._seen_cycles: "Set[Tuple[str, ...]]" = set()
        self._outliers: "Dict[str, int]" = {}

    def add_edge(self, a: str, b: str) -> "Optional[Tuple[str, ...]]":
        """Record ``a`` held while acquiring ``b``; returns a cycle path
        (``b -> ... -> a -> b``) the first time one is closed, else None.

        Bounded acquire on the bookkeeping mutex: a signal handler that
        (against the lint rule) touches a checked lock must degrade to an
        untracked acquisition rather than self-deadlock on graph state
        the interrupted thread holds."""
        if not self._mu.acquire(timeout=0.2):
            return None
        try:
            if a == b:
                # same-name nesting (two instances from one site, e.g. two
                # PGs' _lock) is order-ambiguous by construction — report
                # it as the tightest cycle rather than silently
                # self-looping the graph.
                path = (a, b)
                self._edges.setdefault(a, set()).add(b)
                if path in self._seen_cycles:
                    return None
                self._seen_cycles.add(path)
                self._cycles.append(path)
                return path
            known = self._edges.setdefault(a, set())
            if b in known:
                return None
            known.add(b)
            # DFS from b looking for a path back to a (edge set is small:
            # names are per-site, not per-instance)
            path = self._find_path(b, a)
            if path is None:
                return None
            cycle = tuple(path) + (b,)
            canon = _canonical(cycle)
            if canon in self._seen_cycles:
                return None
            self._seen_cycles.add(canon)
            self._cycles.append(cycle)
            return cycle
        finally:
            self._mu.release()

    def _find_path(self, src: str, dst: str) -> "Optional[List[str]]":
        stack: "List[Tuple[str, List[str]]]" = [(src, [src])]
        visited: "Set[str]" = set()
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            if node in visited:
                continue
            visited.add(node)
            for nxt in self._edges.get(node, ()):
                stack.append((nxt, path + [nxt]))
        return None

    def add_outlier(self, name: str) -> None:
        if not self._mu.acquire(timeout=0.2):
            return  # same degradation policy as add_edge
        try:
            self._outliers[name] = self._outliers.get(name, 0) + 1
        finally:
            self._mu.release()

    def snapshot_cycles(self) -> "List[Tuple[str, ...]]":
        with self._mu:
            return list(self._cycles)

    def snapshot_edges(self) -> "Dict[str, Set[str]]":
        with self._mu:
            return {k: set(v) for k, v in self._edges.items()}

    def snapshot_outliers(self) -> "Dict[str, int]":
        with self._mu:
            return dict(self._outliers)

    def clear(self) -> None:
        with self._mu:
            self._edges.clear()
            self._cycles.clear()
            self._seen_cycles.clear()
            self._outliers.clear()


def _canonical(cycle: "Tuple[str, ...]") -> "Tuple[str, ...]":
    """Rotation-invariant key for a cycle path (first node repeated last)."""
    body = cycle[:-1]
    i = body.index(min(body))
    return body[i:] + body[:i]


_GRAPH = _Graph()


class _ThreadState(threading.local):
    def __init__(self) -> None:
        self.held: "List[CheckedLock]" = []
        self.reporting = False  # reentrancy guard for the metrics leg


_TLS = _ThreadState()


def _report_cycle(cycle: "Tuple[str, ...]") -> None:
    edge = " -> ".join(cycle)
    logger.error(
        "lock-order cycle detected (potential deadlock): %s "
        "(set a consistent acquisition order or split the critical section)",
        edge,
    )
    if _TLS.reporting:
        return
    _TLS.reporting = True
    try:
        from torchft_tpu_torch.utils import metrics as _metrics

        _metrics.LOCK_CYCLES.labels(edge=edge).inc()
    except Exception:  # noqa: BLE001 - detector never takes down training
        logger.exception("lock cycle metric failed")
    finally:
        _TLS.reporting = False


def _report_outlier(name: str, held_s: float) -> None:
    _GRAPH.add_outlier(name)
    logger.warning("lock %s held %.3fs (> hold-time threshold)", name, held_s)
    if _TLS.reporting:
        return
    _TLS.reporting = True
    try:
        from torchft_tpu_torch.utils import metrics as _metrics

        _metrics.LOCK_HOLD_OUTLIERS.labels(name=name).inc()
    except Exception:  # noqa: BLE001
        logger.exception("lock hold-outlier metric failed")
    finally:
        _TLS.reporting = False


class CheckedLock:
    """Order- and hold-time-instrumented wrapper over a threading lock.

    API-compatible with ``threading.Lock``/``RLock`` for every use in
    this package, including as the underlying lock of a
    ``threading.Condition`` (whose ``wait()`` releases and reacquires
    through ``acquire``/``release``, keeping the held-stack accurate).
    """

    __slots__ = ("_name", "_inner", "_reentrant", "_gate", "_acquired_ns", "_depth_tls")

    def __init__(self, name: str, reentrant: bool = False, gate: bool = False) -> None:
        self._name = name
        self._reentrant = reentrant
        # A *gate* is held on behalf of a community and may be released by
        # a different thread than acquired it (e.g. rwlock's writer gate,
        # taken by the first reader and dropped by the last): thread-local
        # ordering analysis produces nonsense for it, so gates keep only
        # hold-time instrumentation and stay out of the order graph.
        self._gate = gate
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._acquired_ns = 0  # stamped by the acquiring thread
        # per-thread reentrancy depth (RLock): only the outermost
        # acquire/release mutates the held stack and the order graph
        self._depth_tls = threading.local()

    @property
    def name(self) -> str:
        return self._name

    def _depth(self) -> int:
        return getattr(self._depth_tls, "d", 0)

    def _set_depth(self, d: int) -> None:
        self._depth_tls.d = d

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        tls = _TLS
        # The ordering fact is the *attempt* while holding: a deadlocked
        # acquire never succeeds, and the attempt is exactly the evidence
        # the order graph needs.
        track = (
            not tls.reporting
            and not self._gate
            and not (self._reentrant and self._depth() > 0)
        )
        if track and tls.held:
            # a non-blocking probe of a lock this thread already holds
            # (am-I-the-owner idiom) is not an ordering fact
            if not (not blocking and self in tls.held):
                cycle = _GRAPH.add_edge(tls.held[-1]._name, self._name)
                if cycle is not None:
                    _report_cycle(cycle)
        ok = self._inner.acquire(blocking, timeout)
        if not ok:
            return False
        if self._reentrant:
            d = self._depth()
            self._set_depth(d + 1)
            if d > 0:  # inner re-acquire: no new ordering fact
                return True
        if track:
            tls.held.append(self)
        self._acquired_ns = time.monotonic_ns()
        return True

    def release(self) -> None:
        if self._reentrant:
            d = self._depth()
            if d > 1:
                self._set_depth(d - 1)
                self._inner.release()
                return
            self._set_depth(0)
        start_ns = self._acquired_ns
        tls = _TLS
        tracked = False
        if self in tls.held:
            # usually the top of stack; out-of-order release (or a
            # cross-thread release of a lock this thread also holds) just
            # removes the entry
            tls.held.remove(self)
            tracked = True
        held_s = (time.monotonic_ns() - start_ns) / 1e9 if start_ns else 0.0
        self._inner.release()
        # report AFTER releasing: the metrics leg takes its own locks and
        # must not do so while this one is held
        if (tracked or self._gate) and held_s > _hold_threshold_s():
            _report_outlier(self._name, held_s)

    def locked(self) -> bool:
        inner = self._inner
        if self._reentrant:
            if self._depth() > 0:
                return True  # probing our own RLock would lie (reentrant)
            # RLock pre-3.12 lacks locked(); probe without blocking
            if inner.acquire(False):
                inner.release()
                return False
            return True
        return inner.locked()

    def _is_owned(self) -> bool:
        # threading.Condition adopts this hook when present.  Without it
        # the Condition FALLBACK probes lock.acquire(False) while the
        # caller holds the lock — which the attempt-time edge recording
        # above would see as a same-name self-acquisition and report as a
        # false cycle on every wait()/notify().
        if self._reentrant:
            return self._depth() > 0
        if self in _TLS.held:
            return True
        # Untracked hold (gate / reporting path) or another thread's:
        # probe the INNER lock directly — invisible to the order graph,
        # stdlib-fallback semantics otherwise.
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __enter__(self) -> bool:
        self.acquire()
        return True

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<CheckedLock {self._name} {self._inner!r}>"


def enabled() -> bool:
    """Whether new :func:`lock`/:func:`rlock` calls return checked locks."""
    return _enabled


def set_enabled(value: bool) -> None:
    """Override the ``TORCHFT_LOCKCHECK`` gate for locks created *after*
    this call (tests; production uses the env var before import)."""
    global _enabled
    _enabled = bool(value)


def lock(name: str) -> Any:
    """A mutex for the creation site ``name`` (convention:
    ``module.field``, e.g. ``"flightrecorder.ring"``): checked when the
    detector is enabled, else a plain ``threading.Lock``."""
    return CheckedLock(name) if _enabled else threading.Lock()


def rlock(name: str) -> Any:
    """Reentrant variant of :func:`lock`."""
    return CheckedLock(name, reentrant=True) if _enabled else threading.RLock()


def gate(name: str) -> Any:
    """A community-held lock (acquired and released by *different*
    threads, e.g. a readers-writer gate): hold-time instrumented but
    excluded from the order graph, whose thread-local analysis would
    report false cycles for it."""
    return CheckedLock(name, gate=True) if _enabled else threading.Lock()


def cycles() -> "List[Tuple[str, ...]]":
    """Every distinct lock-order cycle observed so far (empty = no
    potential deadlock seen)."""
    return _GRAPH.snapshot_cycles()


def edges() -> "Dict[str, Set[str]]":
    """The observed acquisition-order graph ``{held: {acquired_next}}``."""
    return _GRAPH.snapshot_edges()


def hold_outliers() -> "Dict[str, int]":
    """``{lock name: outlier count}`` for holds past the threshold."""
    return _GRAPH.snapshot_outliers()


def reset() -> None:
    """Clear the graph and reports (test isolation)."""
    _GRAPH.clear()
