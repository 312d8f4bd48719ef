"""Fault-tolerant HSDP on the PyTorch port: fsdp x tp inside each replica
group, elastic replica groups across.

PyTorch port of ``examples/train_hsdp.py`` (reference: torchft README
"HSDP" + fsdp_test.py).  Each replica group is ``--fsdp`` x ``--tp`` rank
processes that shard the model over an inner mesh built by the port's
``ft_init_device_mesh`` (gloo over one host, NCCL when every rank owns a
card); every rank runs its own Manager over its shards (``group_rank`` =
its rank, one store per group), and the Managers average each rank's
gradients with the same rank of the other groups, so a group can die and
rejoin at step granularity while the inner sharding stays as it is.  Ranks
compute on the card unless ``--device cpu`` is given.

Single-machine demo (2 replica groups x 4 rank processes each):

    python examples/torch/train_hsdp.py --local-replicas 2 --steps 20

Real deployment: one launcher process per replica group with
TORCHFT_LIGHTHOUSE set; it spawns the group's rank processes.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=2)
    p.add_argument("--tp", type=int, default=2)
    p.add_argument("--local-replicas", type=int, default=0,
                   help="demo mode: N replica groups + a local lighthouse")
    p.add_argument("--device", default="cuda",
                   help="device every rank computes on (default cuda)")
    return p.parse_args(argv)


def rank_main(replica_id: str, rank: int, lighthouse_addr: str, store_addr: str,
              coordinator: tuple, args) -> None:
    """One rank of one replica group (a spawned process)."""
    import numpy as np
    import torch

    import torchft_tpu_torch as ft
    from torchft_tpu_torch.models import transformer as tfm
    from torchft_tpu_torch.parallel import multihost
    from torchft_tpu_torch.parallel.device_mesh import ft_init_device_mesh
    from torchft_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    n = args.fsdp * args.tp
    if device.type == "cpu":
        torch.set_num_threads(1)  # every rank of every group shares the host
    # several ranks on one card: gloo (NCCL refuses two ranks on one card)
    backend = ("nccl" if device.type == "cuda" and torch.cuda.device_count() >= n
               else "gloo")
    if device.type == "cuda" and backend == "nccl":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    cfg = tfm.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        n_layers=2, max_seq_len=32,
        dtype=torch.float32 if device.type == "cpu" else torch.bfloat16,
    )
    # rank 0's store serves on the listener the parent bound
    address, listener = coordinator
    world = multihost.initialize_multihost(
        address, n, rank, backend=backend, timeout=60.0, listener=listener)
    model = tfm.init_params(torch.Generator().manual_seed(0), cfg, device)
    holder = {}

    def load_state_dict(sd):
        model.load_state_dict(sd["model"])
        holder["opt"].load_state_dict(sd["optim"])

    manager = ft.Manager(
        pg=ft.ProcessGroupTCP(timeout=30.0),
        min_replica_size=args.min_replicas,
        lighthouse_addr=lighthouse_addr,
        replica_id=replica_id,
        group_rank=rank,
        group_world_size=n,
        store_addr=store_addr,
        use_async_quorum=False,
        timeout=30.0,
        quorum_timeout=60.0,
        load_state_dict=load_state_dict,
        state_dict=lambda: {"model": model.state_dict(),
                            "optim": holder["opt"].state_dict()},
    )
    try:
        mesh = ft_init_device_mesh(manager, {"fsdp": args.fsdp, "tp": args.tp},
                                   groups=world, device=device).mesh
        tfm.shard_params(model, mesh)  # in place: this rank keeps its shards
        opt = holder["opt"] = torch.optim.AdamW(model.parameters(), lr=args.lr)
        optimizer = ft.OptimizerWrapper(manager, opt)
        ddp = ft.DistributedDataParallel(manager)
        grad_step = tfm.make_grad_step(cfg, mesh)
        # every rank draws the group's whole batch from the group's seed;
        # make_grad_step takes the rows and columns of its rank
        rng = np.random.default_rng(hash(replica_id) % 2**31)
        while manager.current_step() < args.steps:
            optimizer.begin_step()  # starts the quorum (sync: heal lands here)
            # per-replica batch shape stays FIXED under elastic membership
            # (WorldSizeMode.DYNAMIC semantics)
            tokens = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (args.batch_size, cfg.max_seq_len))).to(device)
            loss, _ = grad_step(model, tokens)
            avg = ddp.allreduce_gradients(ft.module_grads(model)).wait(timeout=30)
            if optimizer.step(model, avg) and rank == 0:
                step = manager.current_step()
                if step % 5 == 0:
                    print(f"[{replica_id} step {step}] loss={float(loss):.4f} "
                          f"participants={manager.num_participants()}", flush=True)
        if rank == 0:
            print(f"done: {manager.current_step()} committed steps", flush=True)
    finally:
        manager.shutdown()


def run_group(replica_id: str, lighthouse_addr: str, args) -> int:
    """Spawn one replica group's ``fsdp * tp`` rank processes around a store
    and an in-group coordinator of their own; raises unless every rank
    exits 0."""
    import multiprocessing as mp

    from torchft_tpu_torch.coordination import StoreServer
    from torchft_tpu_torch.parallel.multihost import coordinator_listener

    ctx = mp.get_context("spawn")
    store = StoreServer()
    address, listener = coordinator_listener()
    procs = [
        ctx.Process(target=rank_main, args=(replica_id, r, lighthouse_addr, store.address(),
                                            (address, listener if r == 0 else None), args))
        for r in range(args.fsdp * args.tp)
    ]
    try:
        try:
            for p in procs:
                p.start()
        finally:
            listener.close()  # rank 0 holds its own copy
        for p in procs:
            p.join()
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        store.shutdown()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"{replica_id}: rank exit codes {codes}")
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.local_replicas:
        from _demo import run_demo

        return run_demo(
            run_group, args.local_replicas, min_replicas=args.min_replicas,
            replica_prefix="hsdp", extra_args=(args,),
        )
    from _demo import resolve_lighthouse

    replica_id = f"hsdp_{os.environ.get('REPLICA_GROUP_ID', 0)}"
    return run_group(replica_id, resolve_lighthouse(), args)


if __name__ == "__main__":
    sys.exit(main())
