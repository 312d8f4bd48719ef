"""Checkpoint-transport throughput benchmarks.

PyTorch port of ``torchft_tpu/checkpointing/transport_bench.py``: build a
model-shaped state dict of f32 tensors on one device, send it from one
endpoint to another in this process, and report seconds and GiB/s per leg.
``bench_http`` goes over the port's ``HTTPTransport``; ``bench_pg`` over
``PGTransport`` on two ``ProcessGroupTCP`` ranks joined through a
``StoreServer``.  Each leg runs twice: into fresh tensors, then in place
into a live state dict of the same structure on the device (the heal path's
receive).  Every received leaf is checked bitwise against the one sent,
outside the timed region.

    python -m torchft_tpu_torch.checkpointing.transport_bench --gb 1.0
    python -m torchft_tpu_torch.checkpointing.transport_bench \
        --transport http --gb 1.0 --chunks 8 --device cpu

The state lives on the card unless ``--device cpu`` is given; there is no
fallback to the CPU when the card is missing.
"""

from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict

import torch

from torchft_tpu_torch.utils.device import resolve_device


def make_state_dict(
    total_bytes: int, device: "str | torch.device" = "cuda", leaf_mb: int = 64
) -> "Dict[str, torch.Tensor]":
    """Synthetic model-shaped state dict of f32 leaves (~``leaf_mb`` each,
    at least one) drawn from seed 0 on ``device``."""
    leaf_elems = leaf_mb * 1024 * 1024 // 4
    if total_bytes < leaf_elems * 4:
        leaf_elems = max(total_bytes // 4, 1)
    n_leaves = max(1, total_bytes // (leaf_elems * 4))
    gen = torch.Generator().manual_seed(0)
    return {
        f"layer_{i}": torch.randn(leaf_elems, generator=gen).to(device)
        for i in range(n_leaves)
    }


def _nbytes(state: "Dict[str, torch.Tensor]") -> int:
    return sum(t.numel() * t.element_size() for t in state.values())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_received(state: "Dict[str, torch.Tensor]", got: "Dict[str, Any]") -> None:
    """Raise unless ``got`` holds every leaf of ``state``, bit for bit."""
    if set(got) != set(state):
        raise AssertionError(f"received keys {sorted(got)} != sent {sorted(state)}")
    for k, want in state.items():
        have = torch.as_tensor(got[k]).to(want.device)
        if have.dtype != want.dtype or not torch.equal(
                have.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"leaf {k} differs from the one sent")


def bench_http(
    gb: float, chunks: int = 0, device: "str | torch.device" = "cuda"
) -> "Dict[str, float]":
    from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport

    dev = resolve_device(device)
    state = make_state_dict(int(gb * 1024**3), dev)
    nbytes = _nbytes(state)
    # warm in-place target: the live-training heal path receives into
    # existing parameter tensors on the device
    live = {k: torch.zeros_like(v) for k, v in state.items()}
    _sync(dev)

    sender = HTTPTransport(timeout=300.0, num_chunks=chunks)
    receiver = HTTPTransport(timeout=300.0, num_chunks=chunks)
    receiver_inplace = HTTPTransport(
        timeout=300.0, num_chunks=chunks, state_dict_fn=lambda: live
    )
    try:
        t0 = time.perf_counter()
        sender.send_checkpoint([1], step=1, state_dict=state, timeout=300.0)
        t_send = time.perf_counter() - t0

        t0 = time.perf_counter()
        got = receiver.recv_checkpoint(
            src_rank=0, metadata=sender.metadata(), step=1, timeout=300.0
        )
        t_recv = time.perf_counter() - t0
        check_received(state, got)

        t0 = time.perf_counter()
        got = receiver_inplace.recv_checkpoint(
            src_rank=0, metadata=sender.metadata(), step=1, timeout=300.0
        )
        _sync(dev)
        t_inplace = time.perf_counter() - t0
        check_received(state, got)
        check_received(state, live)
        return {
            "bytes": nbytes,
            "stage_s": t_send,
            "recv_s": t_recv,
            "inplace_s": t_inplace,
            "gbps": nbytes / t_recv / 1024**3,
            "inplace_gbps": nbytes / t_inplace / 1024**3,
        }
    finally:
        sender.shutdown()
        receiver.shutdown()
        receiver_inplace.shutdown()


def bench_pg(gb: float, device: "str | torch.device" = "cuda") -> "Dict[str, float]":
    from torchft_tpu_torch.checkpointing.pg_transport import PGTransport
    from torchft_tpu_torch.coordination import StoreServer
    from torchft_tpu_torch.parallel.process_group import ProcessGroupTCP

    dev = resolve_device(device)
    state = make_state_dict(int(gb * 1024**3), dev)
    nbytes = _nbytes(state)
    live = {k: torch.zeros_like(v) for k, v in state.items()}
    _sync(dev)

    store = StoreServer()
    pgs = [ProcessGroupTCP(timeout=300.0) for _ in range(2)]
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = [
            ex.submit(pgs[r].configure, f"{store.address()}/bench", f"r{r}", r, 2)
            for r in range(2)
        ]
        [f.result() for f in futs]

    sender = PGTransport(pgs[0], timeout=300.0)
    receiver = PGTransport(pgs[1], timeout=300.0)
    receiver_inplace = PGTransport(pgs[1], timeout=300.0, state_dict_fn=lambda: live)
    try:
        def run(recv_transport: PGTransport) -> "tuple[float, Any]":
            def send() -> None:
                sender.send_checkpoint([1], step=1, state_dict=state, timeout=300.0)

            def recv() -> Any:
                return recv_transport.recv_checkpoint(
                    src_rank=0, metadata=sender.metadata(), step=1, timeout=300.0
                )

            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=2) as ex:
                fs = ex.submit(send)
                fr = ex.submit(recv)
                got = fr.result(timeout=600)
                fs.result(timeout=600)
            _sync(dev)
            return time.perf_counter() - t0, got

        t_cold, got = run(receiver)
        check_received(state, got)
        t_inplace, got = run(receiver_inplace)
        check_received(state, got)
        check_received(state, live)
        return {
            "bytes": nbytes,
            "total_s": t_cold,
            "inplace_s": t_inplace,
            "gbps": nbytes / t_cold / 1024**3,
            "inplace_gbps": nbytes / t_inplace / 1024**3,
        }
    finally:
        for t in (sender, receiver, receiver_inplace):
            t.shutdown()
        for pg in pgs:
            pg.shutdown()
        store.shutdown()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--transport", choices=("http", "pg", "both"), default="both")
    p.add_argument("--gb", type=float, default=1.0, help="state dict size in GiB")
    p.add_argument("--chunks", type=int, default=0,
                   help="HTTP: parallel chunk fetches (0 = single stream)")
    p.add_argument("--device", default="cuda",
                   help="device the state dict lives on (default cuda)")
    args = p.parse_args(argv)

    if args.transport in ("http", "both"):
        r = bench_http(args.gb, args.chunks, args.device)
        print(
            f"http  {args.gb:.1f} GiB on {args.device} chunks={args.chunks}: "
            f"stage {r['stage_s']:.2f}s  recv {r['recv_s']:.2f}s "
            f"({r['gbps']:.2f} GiB/s)  in-place recv {r['inplace_s']:.2f}s "
            f"({r['inplace_gbps']:.2f} GiB/s)"
        )
    if args.transport in ("pg", "both"):
        r = bench_pg(args.gb, args.device)
        print(
            f"pg    {args.gb:.1f} GiB on {args.device}: send+recv {r['total_s']:.2f}s "
            f"({r['gbps']:.2f} GiB/s)  in-place {r['inplace_s']:.2f}s "
            f"({r['inplace_gbps']:.2f} GiB/s)"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
