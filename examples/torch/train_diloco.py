"""Streaming DiLoCo training example on the PyTorch port.

PyTorch port of ``examples/train_diloco.py`` (reference:
train_diloco.py:76-238).  Communication-reducing semi-sync data
parallelism: each replica group trains locally for ``--sync-every`` inner
steps; parameter fragments are synchronized round-robin with
pseudogradient allreduces overlapped with compute
(``--fragment-sync-delay``), an outer Nesterov-SGD step applied on commit.
Ideal when replica groups are connected by slow links.  Each group runs on
the card unless ``--device cpu`` (or ``--cpu``) is given; with
``--quantize`` the card quantizes the pseudogradients (kernel D).

Single-machine demo:

    python examples/torch/train_diloco.py --local-replicas 2 --steps 40

Real deployment (one process per card):

    TORCHFT_LIGHTHOUSE=host:port REPLICA_GROUP_ID=0 python examples/torch/train_diloco.py

Model: MLP fragments (contiguous ``layer_{i}`` partitions,
``models/mlp.fragment_keys``).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=80, help="inner steps to run")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--inner-lr", type=float, default=4e-4)
    p.add_argument("--outer-lr", type=float, default=0.7)
    p.add_argument("--sync-every", type=int, default=20,
                   help="inner steps per full sync round (reference default)")
    p.add_argument("--fragment-sync-delay", type=int, default=1,
                   help="steps between kicking off a fragment allreduce and "
                        "blocking on it")
    p.add_argument("--n-fragments", type=int, default=2)
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--local-replicas", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="device each replica group trains on (default cuda)")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    p.add_argument("--wire-gbps", type=float, default=None,
                   help="shape the egress to this rate (decimal GB/s, token "
                        "bucket): DiLoCo under a real bandwidth constraint; "
                        "also settable via TORCHFT_WIRE_GBPS")
    p.add_argument("--quantize", action="store_true",
                   help="int8-quantize the outer pseudogradient sync "
                        "(TORCHFT_QUANT_WIRE selects int8/fp8_e4m3)")
    args = p.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    return args


def train(replica_id: str, lighthouse_addr: str, args, log=print) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    import torchft_tpu_torch as ft
    from torchft_tpu_torch.local_sgd import OuterSGD
    from torchft_tpu_torch.models import mlp
    from torchft_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    model = mlp.init_params(torch.Generator().manual_seed(0),
                            sizes=(64, 128, 128, 128, 10), device=device)
    live = dict(model.named_parameters())

    manager = ft.Manager(
        # --wire-gbps: token-bucket egress shaping (None = unshaped or the
        # TORCHFT_WIRE_GBPS env default)
        pg=ft.ProcessGroupTCP(timeout=30.0, bandwidth_gbps=args.wire_gbps),
        min_replica_size=args.min_replicas,
        replica_id=replica_id,
        lighthouse_addr=lighthouse_addr,
        group_rank=0,
        group_world_size=1,
        use_async_quorum=False,  # DiLoCo requires a synchronous quorum
        timeout=30.0,
    )

    # fragments = contiguous layer partitions, by parameter name
    fragments = [[f"{layer}.{kind}" for layer in keys for kind in ("weight", "bias")]
                 for keys in mlp.fragment_keys(model, args.n_fragments)]

    def get_params():
        return dict(live)

    def set_params(flat):
        with torch.no_grad():
            for name, value in flat.items():
                if value is not live[name]:
                    live[name].copy_(value)

    inner_opt = torch.optim.AdamW(model.parameters(), lr=args.inner_lr)
    outer_opt = OuterSGD(args.outer_lr, momentum=0.9, nesterov=True)

    rng = np.random.default_rng(hash(replica_id) % 2**31)
    try:
        with ft.DiLoCo(
            manager,
            fragments,
            get_params,
            set_params,
            outer_opt,
            sync_every=args.sync_every,
            fragment_sync_delay=args.fragment_sync_delay,
            should_quantize=args.quantize,
        ) as diloco:
            for i in range(args.steps):
                x = torch.from_numpy(
                    rng.standard_normal((args.batch_size, 64), dtype=np.float32)
                ).to(device)
                y = torch.from_numpy(rng.integers(0, 10, args.batch_size)).to(device)
                inner_opt.zero_grad(set_to_none=True)
                loss = F.cross_entropy(model(x), y)
                loss.backward()
                inner_opt.step()
                diloco.step()  # counts inner steps; syncs on its schedule
                if i % 10 == 0:
                    log(f"[{replica_id} inner {i} outer "
                        f"{manager.current_step()}] loss={float(loss.detach()):.4f}")
        return {"model": model, "outer_steps": manager.current_step()}
    finally:
        manager.shutdown()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.local_replicas:
        from _demo import run_demo

        rc = run_demo(
            train, args.local_replicas, min_replicas=args.min_replicas,
            replica_prefix="train_diloco", extra_args=(args,),
        )
        if rc == 0:
            print(f"done: {args.local_replicas} replica groups, {args.steps} inner "
                  f"steps each on {args.device}")
        return rc
    from _demo import resolve_lighthouse

    replica_id = f"train_diloco_{os.environ.get('REPLICA_GROUP_ID', 0)}"
    result = train(replica_id, resolve_lighthouse(), args)
    print(f"done: {result['outer_steps']} outer steps committed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
