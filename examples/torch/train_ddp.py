"""Fault-tolerant DDP training example on the PyTorch port.

PyTorch port of ``examples/train_ddp.py`` (reference: train_ddp.py:104-213).
One process = one replica group (a card, or a CPU worker).  Point every
replica at the same Lighthouse and they form an elastic quorum: kill any
replica mid-run and the rest keep training; restart it and it live-heals
its weights from a healthy peer, with no full-job restart.  Each group runs
on the card unless ``--device cpu`` (or ``--cpu``) is given.

Single-machine demo (threads-as-replicas + in-process Lighthouse):

    python examples/torch/train_ddp.py --local-replicas 2 --steps 50

Real deployment (one process per card):

    TORCHFT_LIGHTHOUSE=host:port REPLICA_GROUP_ID=0 python examples/torch/train_ddp.py
    TORCHFT_LIGHTHOUSE=host:port REPLICA_GROUP_ID=1 python examples/torch/train_ddp.py

The model is the reference's CIFAR-shaped CNN on synthetic data, drawn on
the host from a seed per replica; swap in a real dataloader and the
DistributedSampler shard for production.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=100, help="committed steps to train")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--sync-quorum", action="store_true",
                   help="synchronous quorum (default overlaps with forward)")
    p.add_argument("--local-replicas", type=int, default=0,
                   help="demo mode: run N replica-group threads + a local Lighthouse")
    p.add_argument("--device", default="cuda",
                   help="device each replica group trains on (default cuda)")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace here (Chrome/Perfetto format)")
    p.add_argument("--save-dir", default=None,
                   help="write durable checkpoints here (cold-start resume)")
    p.add_argument("--save-every", type=int, default=10,
                   help="checkpoint every N committed steps")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --save-dir")
    args = p.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    return args


def train(replica_id: str, lighthouse_addr: str, args, log=print) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    import torchft_tpu_torch as ft
    from torchft_tpu_torch.models import cnn
    from torchft_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    model = cnn.init_params(torch.Generator().manual_seed(0), device=device)
    opt = torch.optim.AdamW(model.parameters(), lr=args.lr)

    def load_state_dict(sd):
        model.load_state_dict(sd["model"])
        opt.load_state_dict(sd["optim"])

    manager = ft.Manager(
        pg=ft.ProcessGroupTCP(timeout=30.0),
        min_replica_size=args.min_replicas,
        load_state_dict=load_state_dict,
        state_dict=lambda: {"model": model.state_dict(), "optim": opt.state_dict()},
        replica_id=replica_id,
        lighthouse_addr=lighthouse_addr,
        group_rank=0,
        group_world_size=1,
        use_async_quorum=not args.sync_quorum,
        timeout=30.0,
    )
    ddp = ft.DistributedDataParallel(manager)
    optimizer = ft.OptimizerWrapper(manager, opt)

    # Durable resume (total-failure case: no live peer to heal from).
    # Restores user state AND the torchft step so the quorum resumes from
    # the checkpointed step (reference: train_ddp.py:201-208).
    if args.resume and args.save_dir:
        from torchft_tpu_torch.checkpointing import latest_checkpoint, load_checkpoint

        path = latest_checkpoint(args.save_dir)
        if path is not None:
            ckpt = load_checkpoint(path)
            load_state_dict(ckpt["user"])
            manager.load_state_dict(ckpt["torchft"])
            log(f"[{replica_id}] resumed from {path} "
                f"at step {manager.current_step()}")

    rng = np.random.default_rng(hash(replica_id) % 2**31)
    try:
        while manager.current_step() < args.steps:
            # synthetic CIFAR-shaped batch; each replica sees its own data
            images = torch.from_numpy(
                rng.standard_normal((args.batch_size, 32, 32, 3), dtype=np.float32)
            ).to(device)
            labels = torch.from_numpy(rng.integers(0, 10, args.batch_size)).to(device)

            # must be called at the start of each step: triggers the quorum
            # (overlapped with forward unless --sync-quorum)
            optimizer.begin_step()

            loss = F.cross_entropy(model(images), labels)
            loss.backward()
            # gradient averaging over the live quorum
            avg_grads = ddp.allreduce_gradients(ft.module_grads(model)).wait(timeout=30)

            # applies the update only if the group votes to commit
            committed = optimizer.step(model, avg_grads)
            if committed and manager.current_step() % 10 == 0:
                log(f"[{replica_id} step {manager.current_step()}] "
                    f"loss={float(loss.detach()):.4f} "
                    f"participants={manager.num_participants()}")
            if (
                committed
                and args.save_dir
                and manager.current_step() % args.save_every == 0
                and manager.participating_rank() == 0
            ):
                # single-writer: the participating-rank-0 replica saves the
                # composite {user, torchft} dict (others would write the
                # same bytes)
                from torchft_tpu_torch.checkpointing import save_checkpoint

                path = save_checkpoint(
                    args.save_dir,
                    manager.current_step(),
                    {
                        "user": {"model": model.state_dict(), "optim": opt.state_dict()},
                        "torchft": manager.state_dict(),
                    },
                )
                log(f"[{replica_id}] saved checkpoint {path}")
        return {"model": model, "step": manager.current_step()}
    finally:
        manager.shutdown()


def main(argv=None) -> int:
    args = parse_args(argv)
    profiler = None
    if args.profile_dir:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if args.device != "cpu":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
    try:
        if args.local_replicas:
            from _demo import run_demo

            rc = run_demo(
                train, args.local_replicas, min_replicas=args.min_replicas,
                replica_prefix="train_ddp", extra_args=(args,),
            )
        else:
            from _demo import resolve_lighthouse

            replica_id = f"train_ddp_{os.environ.get('REPLICA_GROUP_ID', 0)}"
            result = train(replica_id, resolve_lighthouse(), args)
            print(f"done: {result['step']} committed steps")
            rc = 0
    finally:
        if profiler is not None:
            profiler.stop()
            os.makedirs(args.profile_dir, exist_ok=True)
            path = os.path.join(args.profile_dir, "trace.json")
            profiler.export_chrome_trace(path)
            print(f"profiler trace written to {path}")
    if args.local_replicas and rc == 0:
        print(f"done: {args.local_replicas} replica groups, {args.steps} committed steps "
              f"each on {args.device}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
