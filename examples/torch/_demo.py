"""Shared single-machine demo scaffolding for the port's example trainers.

PyTorch port of ``examples/_demo.py``: one process hosts a Lighthouse plus
N replica-group threads, the demo analog of one process per card.  A
replica whose train function raises is surfaced: the demo exits nonzero
with the traceback instead of silently reporting success.
"""

from __future__ import annotations

import os
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Sequence


def run_demo(
    train: "Callable[..., Any]",
    n_replicas: int,
    min_replicas: int = 1,
    replica_prefix: str = "replica",
    extra_args: "Sequence[Any]" = (),
    join_timeout_ms: int = 200,
) -> int:
    """Run ``train(replica_id, lighthouse_addr, *extra_args)`` on one thread
    per replica group against an in-process Lighthouse.  Returns a process
    exit code (0 iff every replica finished cleanly)."""
    from torchft_tpu_torch.coordination import LighthouseServer

    lighthouse = LighthouseServer(
        min_replicas=min_replicas, join_timeout_ms=join_timeout_ms
    )
    print(f"lighthouse dashboard: http://{lighthouse.address()}/")
    try:
        failures = 0
        with ThreadPoolExecutor(max_workers=n_replicas) as ex:
            futures = [
                ex.submit(train, f"{replica_prefix}_{i}", lighthouse.address(),
                          *extra_args)
                for i in range(n_replicas)
            ]
            for i, f in enumerate(futures):
                try:
                    f.result()
                except Exception:  # noqa: BLE001 - surfaced to the operator
                    traceback.print_exc()
                    print(f"replica {i} FAILED")
                    failures += 1
        return 1 if failures else 0
    finally:
        lighthouse.shutdown()


def resolve_lighthouse() -> str:
    """Deployment mode: the lighthouse address from the environment."""
    addr = os.environ.get("TORCHFT_LIGHTHOUSE")
    if not addr:
        raise SystemExit(
            "set TORCHFT_LIGHTHOUSE=host:port (or use --local-replicas N)"
        )
    return addr
