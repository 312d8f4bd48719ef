"""HSDP across spawned processes: a sharded replica group killed and healed.

The port of tests/test_multihost_integ.py's chaos case: two replica groups
of two processes each, every process with its own Manager (``group_rank``
= its rank in the group) over its fsdp shards (inner mesh ``{"fsdp": 2}``
from ``initialize_multihost`` over a TCPStore, gloo).  Group 1's processes
are SIGKILLed after their second commit and restarted; each heals from the
same rank of group 0 at the survivors' step, and all four processes end
with rank r of both groups bitwise equal.  A ``cuda``-marked case runs
``{"fsdp": 2, "tp": 2}`` over NCCL on four cards (one each), for
correctness only (on the card: ``python3 -m pytest
tests/test_torch_hsdp_processes.py -m cuda -q`` on a machine with four
cards).  This file imports no JAX, so that the spawned processes, which
import it, start quickly.
"""

import hashlib
import multiprocessing as mp
import queue
import time

import numpy as np
import pytest
import torch

from torchft_tpu_torch.models import transformer as ttf
from torchft_tpu_torch.parallel import device_mesh as tdm
from torchft_tpu_torch.parallel import multihost

STEPS = 5
KILL_AFTER = 2
CFG = dict(
    vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
    n_layers=2, max_seq_len=16,
)
#: the four-card case: the flagship's head ratios (6 query heads over 3 KV
#: heads, which tp = 2 does not divide) at head width 64, T = 128
CUDA_CFG = dict(
    vocab_size=256, d_model=384, n_heads=6, n_kv_heads=3, d_ff=512,
    n_layers=2, max_seq_len=128,
)


def _digests(model, opt):
    """sha256 of every parameter's and AdamW state tensor's bytes, by name."""
    names = {id(p): n for n, p in model.named_parameters()}
    leaves = dict(model.named_parameters())
    for p, state in opt.state.items():
        for k, v in state.items():
            leaves[f"{names[id(p)]}/{k}"] = v
    return {n: hashlib.sha256(t.detach().contiguous().reshape(-1).view(torch.uint8)
                              .numpy()).hexdigest() for n, t in leaves.items()}


def _group_rank(gid, rank, life, lighthouse, store, coordinator, park, results):
    """Rank ``rank`` of replica group ``gid`` in its ``life``-th
    incarnation: trains to ``STEPS`` under its Manager; group 1's first
    incarnation reports on ``park`` (a pipe of its own, which holds no lock
    that the kill could leave taken, as a ``Queue``'s does) after commit
    ``KILL_AFTER`` and waits to be killed."""
    from torchft_tpu_torch import (
        DistributedDataParallel,
        Manager,
        OptimizerWrapper,
        ProcessGroupTCP,
        module_grads,
    )

    try:
        torch.set_num_threads(1)  # four processes, and a restarted two, share the host
        cfg = ttf.TransformerConfig(dtype=torch.float32, attn_impl="dense", remat=False, **CFG)
        address, listener = coordinator  # rank 0 gets the socket the parent bound
        world = multihost.initialize_multihost(
            address, 2, rank, backend="gloo", timeout=60.0, listener=listener)
        model = ttf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        opt = None
        manager = Manager(
            pg=ProcessGroupTCP(timeout=30.0), min_replica_size=2,
            load_state_dict=lambda sd: (model.load_state_dict(sd["model"]),
                                        opt.load_state_dict(sd["optim"])),
            state_dict=lambda: {"model": model.state_dict(), "optim": opt.state_dict()},
            lighthouse_addr=lighthouse, replica_id=f"hsdp_proc{gid}",
            group_rank=rank, group_world_size=2, store_addr=store,
            use_async_quorum=False, timeout=30.0, quorum_timeout=60.0,
            init_sync=False,
        )
        try:
            mesh = tdm.ft_init_device_mesh(manager, {"fsdp": 2}, groups=world,
                                           device="cpu").mesh
            ttf.shard_params(model, mesh)
            opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
            grad_step = ttf.make_grad_step(cfg, mesh)
            optim = OptimizerWrapper(manager, opt)
            ddp = DistributedDataParallel(manager)
            first_commit, heal = None, None
            while manager.current_step() < STEPS:
                optim.zero_grad()  # the quorum: a restarted rank heals here
                step = manager.current_step()
                if life and heal is None:
                    heal = (step, manager.heal_info().get("wire_bytes", 0))
                tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=torch.Generator()
                                       .manual_seed(100 * gid + step))
                grad_step(model, tokens)
                avg = ddp.allreduce_gradients(module_grads(model)).wait(timeout=30)
                if optim.step(model, avg) and first_commit is None:
                    first_commit = step
                if gid == 1 and life == 0 and manager.current_step() == KILL_AFTER:
                    park.send(rank)
                    while True:  # SIGKILLed here by the parent
                        time.sleep(60.0)
            results.put(("ok", gid, rank, (manager.current_step(), first_commit, heal,
                                           _digests(model, opt))))
        finally:
            manager.shutdown()
    except BaseException:  # noqa: BLE001 - reported to the parent
        import traceback

        results.put(("error", gid, rank, traceback.format_exc()))
        raise


def test_killed_fsdp_group_heals_rank_by_rank_and_ends_bitwise_equal():
    """2 replica groups x 2 processes (inner fsdp = 2): group 1's processes
    are SIGKILLed after their second commit (no shutdown; heartbeats just
    stop) and restarted with a fresh in-group coordinator; the new
    incarnation's first quorum heals each rank from the same rank of group
    0, over the wire, at the survivors' step (not 0), and after the last
    commit rank r of both groups holds the same shards and AdamW state."""
    from torchft_tpu_torch.coordination import LighthouseServer, StoreServer

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    lighthouse = LighthouseServer(min_replicas=2, join_timeout_ms=100,
                                  heartbeat_timeout_ms=5000)
    stores = [StoreServer() for _ in range(2)]
    procs, parks = {}, {}

    def spawn(gid, life):
        address, listener = multihost.coordinator_listener()
        for rank in range(2):
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_group_rank, daemon=True, args=(
                gid, rank, life, lighthouse.address(), stores[gid].address(),
                (address, listener if rank == 0 else None), send, results))
            p.start()
            send.close()
            procs[(gid, rank, life)], parks[(gid, rank, life)] = p, recv
        listener.close()  # rank 0 holds its own copy

    got, parked = {}, set()
    try:
        for gid in range(2):
            spawn(gid, 0)
        deadline = time.monotonic() + 100.0
        while len(got) < 4:
            assert time.monotonic() < deadline, (
                f"no result within 100 s: {sorted(got)}, parked {sorted(parked)}")
            if len(parked) < 2:
                parked |= {r for r in range(2) if parks[(1, r, 0)].poll()}
                if len(parked) == 2:
                    for r in range(2):
                        procs[(1, r, 0)].kill()
                        procs[(1, r, 0)].join(10.0)
                    spawn(1, 1)
            try:
                status, gid, rank, body = results.get(timeout=0.5)
            except queue.Empty:
                dead = [k for k, p in procs.items() if p.exitcode not in (None, 0)
                        and not (k[0] == 1 and k[2] == 0 and len(parked) == 2)]
                assert not dead, f"processes died without a result: {dead}"
                continue
            assert status != "error", f"g{gid}r{rank} failed:\n{body}"
            got[(gid, rank)] = body
        for key, p in procs.items():
            if key[2] == 0 and key[0] == 1:
                continue
            p.join(30.0)
            assert p.exitcode == 0, (key, p.exitcode)
    finally:
        for p in procs.values():
            if p.is_alive():
                p.kill()
        for c in parks.values():
            c.close()
        lighthouse.shutdown()
        for s in stores:
            s.shutdown()

    for rank in range(2):
        final0, _, _, state0 = got[(0, rank)]
        final1, first1, heal1, state1 = got[(1, rank)]
        assert final0 == final1 == STEPS
        # healed live at the survivors' step, over the wire
        assert heal1[0] == KILL_AFTER and heal1[1] > 0, heal1
        assert first1 == KILL_AFTER
        assert state0 == state1, [n for n in state0 if state0[n] != state1.get(n)]
    # the two ranks hold different shards
    assert got[(0, 0)][3]["embed"] != got[(0, 1)][3]["embed"]


def _nccl_rank(rank, addr, inputs, results):
    """One of four processes, a card each: the inner mesh ``{"fsdp": 2,
    "tp": 2}`` over NCCL, the bf16 model's sharded loss and gradients
    (flash attention: kernels A-C on the rank's heads), the gradients
    gathered whole and sent to the parent."""
    from torchft_tpu_torch.ops import flash_attention as fa

    try:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        tree, tokens = inputs
        cfg = ttf.TransformerConfig(dtype=torch.bfloat16, attn_impl="flash", remat=False,
                                    **CUDA_CFG)
        address, listener = addr  # rank 0 gets the socket the parent bound
        world = multihost.initialize_multihost(
            address, 4, rank, timeout=120.0, listener=listener)
        assert world.backend == "nccl", world.backend
        mesh = tdm.ft_init_device_mesh(None, {"fsdp": 2, "tp": 2}, groups=world,
                                       device=dev).mesh
        model = ttf.Transformer(cfg, "cpu")
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(torch.from_numpy(tree[n]))
        ttf.shard_params(model, mesh)
        model.to(dev)
        loss, grads = ttf.make_grad_step(cfg, mesh)(model, torch.from_numpy(tokens).to(dev))
        whole = {n: g.float().cpu().numpy()
                 for n, g in ttf.gather_params(grads, cfg, mesh).items()}
        results.put((rank, float(loss), whole if rank == 0 else None,
                     mesh.axis("tp").transport(dev), fa.flash_fwd.launches))
    except BaseException:  # noqa: BLE001 - reported to the parent
        import traceback

        results.put((rank, traceback.format_exc()))
        raise


@pytest.mark.cuda
def test_fsdp2_tp2_across_four_cards_over_nccl():
    """Four processes, a card each, form ``{"fsdp": 2, "tp": 2}`` over
    NCCL (CUDA tensors go to NCCL as they are); the sharded bf16 model's
    loss and gathered gradients against the same weights in f32 with dense
    attention on the CPU: loss to 1e-2 relative, each gradient leaf within
    5e-2 of its norm (phase 10's bound for a bf16 model against f32)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    from torchft_tpu_torch import _kernels

    _kernels.build()  # once, before the four processes load it
    cfg = ttf.TransformerConfig(dtype=torch.float32, attn_impl="dense", remat=False,
                                **CUDA_CFG)
    model = ttf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tree = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 128))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    addr, listener = multihost.coordinator_listener()
    procs = [ctx.Process(target=_nccl_rank, args=(r, (addr, listener if r == 0 else None),
                                                  (tree, tokens), results),
                         daemon=True) for r in range(4)]
    for p in procs:
        p.start()
    listener.close()  # rank 0 holds its own copy
    got = {}
    try:
        while len(got) < 4:
            msg = results.get(timeout=300.0)
            assert len(msg) > 2, f"rank {msg[0]} failed:\n{msg[1]}"
            got[msg[0]] = msg[1:]
        for p in procs:
            p.join(60.0)
            assert p.exitcode == 0
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    loss, grads = ttf.make_grad_step(cfg)(model, torch.from_numpy(tokens).long())
    assert all(got[r][2] == "nccl" and got[r][3] > 0 for r in range(4))
    assert all(abs(got[r][0] - float(loss)) <= 1e-2 * abs(float(loss)) for r in range(4))
    for n, g in grads.items():
        err = float(np.linalg.norm(got[0][1][n] - g.numpy()) / np.linalg.norm(g.numpy()))
        assert err < 5e-2, (n, err)
