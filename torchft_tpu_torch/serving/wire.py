"""Serving-tier WAN wire model (ROADMAP "serving-tier WAN realism").

PyTorch port of ``torchft_tpu/serving/wire.py``; the heal plane prices
fragment fetches that cross the topology boundary with it
(``checkpointing/fragments.py`` ``_charge_wire``).

The training-side shaper (parallel/process_group.py) models the WAN with
two decoupled legs — ``TORCHFT_WIRE_RTT_MS``, a per-MESSAGE first-byte
latency, and ``TORCHFT_WIRE_GBPS``, a shared egress token bucket — both
scoped to messages that cross the ``TORCHFT_TOPOLOGY`` boundary.  This
module applies the SAME model to the serving tier's fetch/relay HTTP
pulls, so serving benches and soaks price multi-region distribution
realistically instead of at loopback speed.

Boundary rule: the serving tier has no rank grid, so the topology
boundary is tested by HOST — with a declared (non-flat)
``TORCHFT_TOPOLOGY``, a fetch whose source host is this machine rides
the local fabric unshaped; with a flat/unset topology EVERY fetch
crosses the boundary (the multi-region premise, and the same default
the PG shaper uses for flat topologies).  A fetch pays one RTT plus
``bytes/rate`` of bucket debt, never more: pacing below one message
would only measure sleep granularity.

Shaping is charged as explicit sleeps on the fetching side after the
response arrives — from the caller's point of view latency and
throughput bound exactly as a shaped link would, without touching the
HTTP stack.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Optional, Tuple
from urllib.parse import urlparse

from torchft_tpu_torch.utils import metrics as _metrics
from torchft_tpu_torch.utils.env import env_float, env_str
from torchft_tpu_torch.utils.hostident import local_host_identities

__all__ = ["WireShaper", "get_shaper", "source_host"]


def source_host(source: str) -> str:
    """The host of a serving source address: a transport base URL
    (``http://host:port``) or a bare ``host:port``."""
    if "://" in source:
        return urlparse(source).hostname or ""
    host, _, _port = source.rpartition(":")
    return host or "127.0.0.1"


class WireShaper:
    """One shaped serving link: per-message RTT + per-SOURCE token
    buckets.

    Each bucket models one serving node's WAN egress uplink (keyed by
    the source address — the sender-side egress semantics of the PG
    shaper): fetches from the SAME source share its pipe, fetches from
    different sources (distinct relays on distinct machines in a real
    deployment) shape independently — which is what lets the depth-axis
    bench see cut-through relays of a chain forwarding concurrently
    instead of serializing every hop through one process-wide bucket.
    ``burst_bytes`` (``TORCHFT_WIRE_BURST_MB``) is each uplink's bucket
    depth.
    """

    def __init__(
        self,
        rtt_ms: float,
        gbps: float,
        topology_spec: str,
        local_hosts: "Optional[Iterable[str]]" = None,
        burst_bytes: int = 4 << 20,
    ) -> None:
        self._rtt_s = max(rtt_ms, 0.0) / 1e3
        self._rate = max(gbps, 0.0) * 1e9  # decimal GB/s, like the PG
        self._flat = not topology_spec or topology_spec.lower() == "flat"
        self._local = (
            frozenset(local_hosts) if local_hosts else local_host_identities()
        )
        self._burst = max(int(burst_bytes), 1)
        # source address -> [tokens, last refill time]
        self._buckets: "dict[str, list[float]]" = {}
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return self._rtt_s > 0.0 or self._rate > 0.0

    def crosses_boundary(self, source: str) -> bool:
        """Flat/unset topology: every fetch is WAN.  Declared topology:
        only fetches from another host are."""
        if self._flat:
            return True
        return source_host(source) not in self._local

    def first_byte_s(self, source: str) -> float:
        """The modeled first-byte latency a fetch from ``source`` pays
        (0 when unshaped or intra-host) — the component of charge() the
        link-state plane attributes to RTT rather than bandwidth."""
        if not self.active or not self.crosses_boundary(source):
            return 0.0
        return self._rtt_s

    def charge(self, source: str, nbytes: int) -> float:
        """Sleep off one message's WAN cost; returns seconds slept."""
        if not self.active or not self.crosses_boundary(source):
            return 0.0
        wait = self._rtt_s
        if self._rate > 0.0 and nbytes > 0:
            with self._lock:
                bucket = self._buckets.get(source)
                if bucket is None:
                    bucket = self._buckets[source] = [
                        float(self._burst), time.monotonic(),
                    ]
                now = time.monotonic()
                bucket[0] = min(
                    float(self._burst),
                    bucket[0] + (now - bucket[1]) * self._rate,
                )
                bucket[1] = now
                bucket[0] -= nbytes
                debt = -bucket[0]
            if debt > 0:
                wait += debt / self._rate
        if wait > 0:
            time.sleep(wait)
            # per-host-pair attribution: shaped waits and the passively
            # measured goodput (utils/linkstats.py) join on the same
            # peer-host key; the worst-K label tier bounds cardinality
            from torchft_tpu_torch.utils import linkstats as _linkstats

            _metrics.SERVING_WIRE_WAIT.labels(
                peer=_linkstats.LINKS.peer_topk_label(
                    source_host(source) or "unknown"
                )
            ).inc(wait)
        return wait


_shaper_lock = threading.Lock()
_shaper: "Optional[WireShaper]" = None
_shaper_key: "Optional[Tuple[float, float, str, float]]" = None


def get_shaper() -> WireShaper:
    """The process-wide serving wire shaper, rebuilt when the shaping
    env knobs change (tests flip them between cases; a steady process
    pays one tuple compare per fetch)."""
    global _shaper, _shaper_key
    key = (
        env_float("TORCHFT_WIRE_RTT_MS", 0.0),
        env_float("TORCHFT_WIRE_GBPS", 0.0),
        env_str("TORCHFT_TOPOLOGY", "") or "",
        env_float("TORCHFT_WIRE_BURST_MB", 4.0, minimum=0.001),
    )
    with _shaper_lock:
        if _shaper is None or key != _shaper_key:
            _shaper = WireShaper(
                key[0], key[1], key[2],
                burst_bytes=int(key[3] * (1 << 20)),
            )
            _shaper_key = key
        return _shaper
