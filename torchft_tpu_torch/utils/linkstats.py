"""Passive per-link bandwidth/RTT estimation (the fleet link-state plane).

ROADMAP item 4's plan synthesizer needs *live measured* per-link
bandwidth and RTT as data (PCCL's premise; Prime shows why
assumed-uniform links are fiction on real fleets).  This registry is the
replica-local half of that plane: a process-wide table keyed by
``(peer, plane)`` fed by every REAL transfer — no active probing:

- ``reduction``  — ProcessGroupTCP message completions (bytes + wall per
  inter-host send, parallel/process_group.py);
- ``fragments``  — the fragment fetch plane (Content-Length + first-byte
  latency, checkpointing/fragments.py — serves both serving pulls and
  striped heal for free);
- ``rpc``        — coordination RPC round trips (coordination.py).

Estimators are a byte-weighted decayed-mean goodput plus a windowed
first-byte latency reservoir (p50/p99).  ``record()`` runs at the
flight-recorder cost bar (one lock + a few float ops + one deque append;
budget-tested in tests/test_linkstats.py) because it sits inside the
collective send path.

The WAN/local distinction is carried per entry (``local`` flag) and in
the key itself: a same-host peer that the declared ``TORCHFT_TOPOLOGY``
places across a boundary is keyed under a ``host#gN`` pseudo-host so a
shaped (WAN-modeled) link is never averaged into the unshaped local
fabric — intra-host pairs report unshaped-fast, WAN pairs report the
modeled link, and the two can never be confused.

Fleet aggregation: ``maybe_digest()`` emits a bounded link table at most
every ``TORCHFT_LINK_REPORT_S`` seconds; the Manager piggybacks it on
the native heartbeat (consumed-on-send, like the per-step digest) and
the lighthouse folds it into the host-pair matrix served at
``/links.json``.  The same cadence refreshes the worst-K-bounded
``torchft_link_*`` gauges (``TORCHFT_LINK_TOPK`` rows per plane; the
fleet-wide truth lives in the unlabeled aggregates — the straggler-tier
cardinality rule, docs/observability.md).

``LinkMatrix.snapshot()`` is the frozen, monotone-versioned view the
plan synthesizer will take as input (docs/architecture.md).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from torchft_tpu_torch.utils.env import env_float, env_int

__all__ = [
    "PLANES",
    "LinkStat",
    "LinkMatrix",
    "LinkRegistry",
    "LINKS",
    "record",
]

#: the three transfer planes a link is measured on
PLANES = ("reduction", "fragments", "rpc")

#: decay applied to the goodput accumulators per sample — a ~32-sample
#: half-life: old shaping regimes fade, single outliers don't dominate
_DECAY = 0.98


@dataclass(frozen=True)
class LinkStat:
    """One measured link, frozen at snapshot time."""

    peer: str
    plane: str
    local: bool
    goodput_bps: float
    rtt_p50_ms: float
    rtt_p99_ms: float
    samples: int
    bytes_total: int
    age_s: float

    def to_dict(self) -> "Dict[str, Any]":
        return {
            "peer": self.peer,
            "plane": self.plane,
            "local": self.local,
            "goodput_bps": round(self.goodput_bps, 1),
            "rtt_ms": round(self.rtt_p50_ms, 3),
            "rtt_p99_ms": round(self.rtt_p99_ms, 3),
            "samples": self.samples,
            "bytes": self.bytes_total,
            "age_s": round(self.age_s, 3),
        }


@dataclass(frozen=True)
class LinkMatrix:
    """A frozen snapshot of the link table with a monotone version —
    the plan-synthesizer input contract (ROADMAP item 4): equal versions
    mean identical entries; a higher version supersedes a lower one."""

    version: int
    entries: "Tuple[LinkStat, ...]"

    def get(self, peer: str, plane: str) -> "Optional[LinkStat]":
        for e in self.entries:
            if e.peer == peer and e.plane == plane:
                return e
        return None


class _Estimator:
    """Per-(peer, plane) accumulators.  All mutation happens under the
    registry lock; no per-estimator lock (record() cost bar)."""

    __slots__ = (
        "local", "bytes_dec", "secs_dec", "fb_window",
        "samples", "bytes_total", "last_mono",
    )

    def __init__(self, local: bool, window: int) -> None:
        self.local = local
        self.bytes_dec = 0.0
        self.secs_dec = 0.0
        self.fb_window: "deque[float]" = deque(maxlen=window)
        self.samples = 0
        self.bytes_total = 0
        self.last_mono = 0.0


def _quantiles(window: "deque[float]") -> "Tuple[float, float]":
    """(p50, p99) of the first-byte window, in seconds."""
    if not window:
        return 0.0, 0.0
    s = sorted(window)
    n = len(s)
    return s[n // 2], s[min(int(n * 0.99), n - 1)]


class LinkRegistry:
    """The process-wide passive link table (module global ``LINKS``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._links: "Dict[Tuple[str, str], _Estimator]" = {}
        self._version = 0
        self._window = env_int("TORCHFT_LINK_WINDOW", 64, minimum=4)
        self._topk = env_int("TORCHFT_LINK_TOPK", 8, minimum=1)
        self._report_s = env_float("TORCHFT_LINK_REPORT_S", 2.0, minimum=0.0)
        self._last_report_mono = 0.0
        # first-K distinct peer names get their own bounded metric label;
        # everyone later folds into "other" (restart-stable: peer names
        # are hosts, not incarnations)
        self._label_peers: "Dict[str, str]" = {}

    # -- configuration ----------------------------------------------------

    def reset(self) -> None:
        """Drop every link and re-read the env knobs (tests flip them)."""
        with self._lock:
            self._links.clear()
            self._label_peers.clear()
            self._version = 0
            self._last_report_mono = 0.0
            self._window = env_int("TORCHFT_LINK_WINDOW", 64, minimum=4)
            self._topk = env_int("TORCHFT_LINK_TOPK", 8, minimum=1)
            self._report_s = env_float(
                "TORCHFT_LINK_REPORT_S", 2.0, minimum=0.0
            )

    # -- hot path ---------------------------------------------------------

    def record(
        self,
        peer: str,
        plane: str,
        nbytes: int,
        seconds: float,
        first_byte_s: "Optional[float]" = None,
        local: bool = False,
    ) -> None:
        """Fold one completed transfer in.  ``seconds`` is the whole
        message wall (first byte included); goodput uses the post-first-
        byte interval so bandwidth and latency estimate independently
        (the two decoupled legs of the wire model)."""
        now = time.monotonic()
        with self._lock:
            est = self._links.get((peer, plane))
            if est is None:
                est = self._links[(peer, plane)] = _Estimator(
                    local, self._window
                )
            xfer = seconds - (first_byte_s or 0.0)
            if nbytes > 0 and xfer > 0.0:
                est.bytes_dec = est.bytes_dec * _DECAY + nbytes
                est.secs_dec = est.secs_dec * _DECAY + xfer
            if first_byte_s is not None:
                est.fb_window.append(first_byte_s)
            est.samples += 1
            est.bytes_total += nbytes
            est.last_mono = now
            self._version += 1

    # -- bounded metric labels (worst-K tier) -----------------------------

    def peer_topk_label(self, peer: str) -> str:
        """Bounded per-peer metric label: the first ``TORCHFT_LINK_TOPK``
        distinct peers keep their name, later ones fold into ``other`` —
        at most K+1 values ever, restart-stable (peers are hosts).  The
        ``metrics-cardinality`` lint recognizes ``*topk_label`` accessors
        as this bounded tier."""
        with self._lock:
            label = self._label_peers.get(peer)
            if label is None:
                label = (
                    peer if len(self._label_peers) < self._topk else "other"
                )
                self._label_peers[peer] = label
            return label

    # -- snapshots --------------------------------------------------------

    def _stat_locked(self, key: "Tuple[str, str]", now: float) -> LinkStat:
        est = self._links[key]
        p50, p99 = _quantiles(est.fb_window)
        return LinkStat(
            peer=key[0],
            plane=key[1],
            local=est.local,
            goodput_bps=(
                est.bytes_dec / est.secs_dec if est.secs_dec > 0.0 else 0.0
            ),
            rtt_p50_ms=p50 * 1e3,
            rtt_p99_ms=p99 * 1e3,
            samples=est.samples,
            bytes_total=est.bytes_total,
            age_s=max(now - est.last_mono, 0.0),
        )

    def snapshot(self) -> LinkMatrix:
        """The frozen, monotone-versioned link matrix."""
        now = time.monotonic()
        with self._lock:
            return LinkMatrix(
                version=self._version,
                entries=tuple(
                    self._stat_locked(k, now) for k in sorted(self._links)
                ),
            )

    def maybe_digest(self, host: str) -> "Optional[Dict[str, Any]]":
        """The heartbeat-piggyback digest, rate-limited to one per
        ``TORCHFT_LINK_REPORT_S``: ``None`` when not due or empty.  Rows
        are bounded to the worst-K WAN links per plane (lowest goodput
        first — the links worth aggregating fleet-wide) plus local-pair
        evidence; the same pass refreshes the worst-K gauges."""
        now = time.monotonic()
        with self._lock:
            if not self._links:
                return None
            if (
                self._report_s > 0.0
                and now - self._last_report_mono < self._report_s
            ):
                return None
            self._last_report_mono = now
            stats = [self._stat_locked(k, now) for k in sorted(self._links)]
            topk = self._topk
        self._export_metrics(stats, topk)
        rows: "List[Dict[str, Any]]" = []
        for plane in PLANES:
            wan = sorted(
                (s for s in stats if s.plane == plane and not s.local),
                key=lambda s: (s.goodput_bps or float("inf")),
            )
            loc = [s for s in stats if s.plane == plane and s.local]
            rows.extend(s.to_dict() for s in wan[:topk])
            rows.extend(s.to_dict() for s in loc[:topk])
        if not rows:
            return None
        return {"host": host, "rows": rows}

    def _export_metrics(self, stats: "List[LinkStat]", topk: int) -> None:
        """Refresh the worst-K-bounded ``torchft_link_*`` gauges plus the
        unlabeled fleet-local aggregates (cardinality contract:
        docs/observability.md "metric cardinality")."""
        from torchft_tpu_torch.utils import metrics as _metrics

        wan = [s for s in stats if not s.local]
        _metrics.LINK_PAIRS.set(len(stats))
        _metrics.LINK_GOODPUT_MIN.set(
            min((s.goodput_bps for s in wan if s.goodput_bps > 0), default=0.0)
        )
        worst = sorted(
            (s for s in wan if s.goodput_bps > 0),
            key=lambda s: s.goodput_bps,
        )[:topk]
        for s in worst:
            _metrics.LINK_GOODPUT.labels(
                peer=self.peer_topk_label(s.peer), plane=s.plane
            ).set(s.goodput_bps)
            _metrics.LINK_RTT_P99.labels(
                peer=self.peer_topk_label(s.peer), plane=s.plane
            ).set(s.rtt_p99_ms / 1e3)


#: the process-wide registry every transfer plane feeds
LINKS = LinkRegistry()


def record(
    peer: str,
    plane: str,
    nbytes: int,
    seconds: float,
    first_byte_s: "Optional[float]" = None,
    local: bool = False,
) -> None:
    """Module-level convenience over ``LINKS.record`` (hot-path feeds
    import the module once and call this)."""
    LINKS.record(
        peer, plane, nbytes, seconds, first_byte_s=first_byte_s, local=local
    )
