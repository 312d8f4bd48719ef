"""Shared fragment-fetch plane — thin alias.

PyTorch port of ``torchft_tpu/serving/fetcher.py``.  The pipelined fetch
plane (persistent per-``(thread, netloc)`` connections, bufpool
``readinto`` receive, 503-poll retry, WAN wire-model charge, per-fragment
flight/span/fault telemetry) lives in ``checkpointing/fragments.py``, so
live healing stripes over the same plane the serving tier relays on;
this module keeps the serving tier's import surface.
"""

from __future__ import annotations

from torchft_tpu_torch.checkpointing.fragments import (  # noqa: F401
    FragmentFetcher,
    close_connections,
    fetch_raw,
    fetch_serialized,
)

__all__ = [
    "FragmentFetcher",
    "fetch_raw",
    "fetch_serialized",
    "close_connections",
]
