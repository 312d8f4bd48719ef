"""Pipeline and expert parallelism across spawned processes: a replica group
of ``{"pp": 2, "ep": 2}`` killed and healed rank by rank.

Two replica groups of four processes each, every process with its own
Manager (``group_rank`` = its rank in the group) over its stage's blocks
and its experts (inner mesh ``{"pp": 2, "ep": 2}`` from
``initialize_multihost`` over a TCPStore, gloo), train a tiny MoE
transformer through the GPipe schedule.  Group 1's processes are SIGKILLed
after their second commit and restarted; each heals from the same rank of
group 0 at the survivors' step, and rank r of both groups ends bitwise
equal.  A ``cuda``-marked case runs the same mesh over NCCL on four cards
(one each) against phase 12's references on the first card (on the card:
``python3 -m pytest tests/test_torch_pp_processes.py -m cuda -q`` on a
machine with four cards).  This file imports no JAX, so that the spawned
processes, which import it, start quickly.  Every wait has a deadline: a
hung rank fails the test.
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

INNER = {"pp": 2, "ep": 2}
SIZE = 4
STEPS = 5
KILL_AFTER = 2
MICROBATCHES = 2
CFG = dict(
    vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, d_ff=48,
    n_layers=2, max_seq_len=16, n_experts=4, moe_top_k=2, moe_capacity_factor=1.25,
)
#: the four-card case: the flagship's head ratios at head width 64, T = 128
CUDA_CFG = dict(
    vocab_size=256, d_model=384, n_heads=6, n_kv_heads=3, d_ff=512,
    n_layers=4, max_seq_len=128, n_experts=4, moe_top_k=2, moe_capacity_factor=1.25,
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
        torch.set_num_threads(1)  # eight processes, and a restarted four, share the host
        cfg = ttf.TransformerConfig(dtype=torch.float32, attn_impl="dense", remat=True, **CFG)
        address, listener = coordinator  # rank 0 gets the socket the parent bound
        world = multihost.initialize_multihost(
            address, SIZE, rank, backend="gloo", timeout=60.0, listener=listener)
        model = ttf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        opt = None
        manager = Manager(
            pg=ProcessGroupTCP(timeout=30.0), min_replica_size=2,
            load_state_dict=lambda sd: (model.load_state_dict(sd["model"]),
                                        opt.load_state_dict(sd["optim"])),
            state_dict=lambda: {"model": model.state_dict(), "optim": opt.state_dict()},
            lighthouse_addr=lighthouse, replica_id=f"pp_proc{gid}",
            group_rank=rank, group_world_size=SIZE, store_addr=store,
            use_async_quorum=False, timeout=30.0, quorum_timeout=60.0,
            init_sync=False,
        )
        try:
            mesh = tdm.ft_init_device_mesh(manager, INNER, groups=world, device="cpu").mesh
            ttf.shard_params(model, mesh)
            opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
            grad_step = ttf.make_grad_step(cfg, mesh, MICROBATCHES)
            optim = OptimizerWrapper(manager, opt)
            ddp = DistributedDataParallel(manager)
            first_commit, heal, losses = None, None, []
            while manager.current_step() < STEPS:
                optim.zero_grad()  # the quorum: a restarted rank heals here
                step = manager.current_step()
                if life and heal is None:
                    heal = (step, manager.heal_info().get("wire_bytes", 0))
                tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=torch.Generator()
                                       .manual_seed(100 * gid + step))
                loss, _ = grad_step(model, tokens)
                losses.append(float(loss))
                avg = ddp.allreduce_gradients(module_grads(model)).wait(timeout=30)
                if optim.step(model, avg) and first_commit is None:
                    first_commit = step
                if gid == 1 and life == 0 and manager.current_step() == KILL_AFTER:
                    park.send(rank)
                    while True:  # SIGKILLed here by the parent
                        time.sleep(60.0)
            results.put(("ok", gid, rank, (manager.current_step(), first_commit, heal,
                                           losses, _digests(model, opt))))
        finally:
            manager.shutdown()
    except BaseException:  # noqa: BLE001 - reported to the parent
        import traceback

        results.put(("error", gid, rank, traceback.format_exc()))
        raise


def test_killed_pp_ep_group_heals_rank_by_rank_and_ends_bitwise_equal():
    """2 replica groups x inner ``{"pp": 2, "ep": 2}`` (8 processes): group
    1's four processes are SIGKILLed after their second commit and
    restarted with a fresh in-group coordinator; each heals from the same
    rank of group 0 (same stage, same experts) at the survivors' step, and
    after the last commit rank r of both groups holds the same blocks,
    experts and AdamW state."""
    from torchft_tpu_torch.coordination import LighthouseServer, StoreServer

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    lighthouse = LighthouseServer(min_replicas=2, join_timeout_ms=100,
                                  heartbeat_timeout_ms=5000)
    stores = [StoreServer() for _ in range(2)]
    procs, parks = {}, {}

    def spawn(gid, life):
        address, listener = multihost.coordinator_listener()
        for rank in range(SIZE):
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
        deadline = time.monotonic() + 150.0
        while len(got) < 2 * SIZE:
            assert time.monotonic() < deadline, (
                f"no result within 150 s: {sorted(got)}, parked {sorted(parked)}")
            if len(parked) < SIZE:
                parked |= {r for r in range(SIZE) if parks[(1, r, 0)].poll()}
                if len(parked) == SIZE:
                    for r in range(SIZE):
                        procs[(1, r, 0)].kill()
                    for r in range(SIZE):
                        procs[(1, r, 0)].join(10.0)
                    spawn(1, 1)
            try:
                status, gid, rank, body = results.get(timeout=0.5)
            except queue.Empty:
                dead = [k for k, p in procs.items() if p.exitcode not in (None, 0)
                        and not (k[0] == 1 and k[2] == 0 and len(parked) == SIZE)]
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

    for rank in range(SIZE):
        final0, _, _, losses0, state0 = got[(0, rank)]
        final1, first1, heal1, _, state1 = got[(1, rank)]
        assert final0 == final1 == STEPS
        # healed live at the survivors' step, over the wire
        assert heal1[0] == KILL_AFTER and heal1[1] > 0, heal1
        assert first1 == KILL_AFTER
        assert state0 == state1, [n for n in state0 if state0[n] != state1.get(n)]
        assert losses0 == got[(0, 0)][3] and all(np.isfinite(losses0))
    # a stage holds its own blocks; the ep ranks of a stage split the experts
    assert {n.split("/")[0] for n in got[(0, 0)][4] if n.startswith("blocks.")} == {
        n.split("/")[0] for n in got[(0, 1)][4] if n.startswith("blocks.")}
    assert not any(n.startswith("blocks.1.") for n in got[(0, 0)][4])
    assert got[(0, 0)][4]["blocks.0.w_gate"] != got[(0, 1)][4]["blocks.0.w_gate"]
    assert got[(0, 0)][4]["blocks.0.router"] == got[(0, 1)][4]["blocks.0.router"]


def _nccl_rank(rank, addr, inputs, results):
    """One of four processes, a card each: ``{"pp": 2, "ep": 2}`` over NCCL,
    the bf16 MoE model's pipelined loss and gradients (flash attention:
    kernels A-C inside the stages), gathered whole with its expert choices
    and sent to the parent."""
    import chip_smoke
    from torchft_tpu_torch.ops import flash_attention as fa

    try:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        tree, tokens = inputs
        cfg = ttf.TransformerConfig(dtype=torch.bfloat16, attn_impl="flash", remat=True,
                                    **CUDA_CFG)
        address, listener = addr  # rank 0 gets the socket the parent bound
        world = multihost.initialize_multihost(
            address, SIZE, rank, timeout=120.0, listener=listener)
        assert world.backend == "nccl", world.backend
        mesh = tdm.ft_init_device_mesh(None, INNER, groups=world, device=dev).mesh
        model = ttf.Transformer(cfg, "cpu")
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(torch.from_numpy(tree[n]))
        ttf.shard_params(model, mesh)
        model.to(dev)
        spy, choices = chip_smoke._record_routing(model)
        real, ttf.moe_ffn_stats = ttf.moe_ffn_stats, spy
        try:
            loss, grads = ttf.make_grad_step(cfg, mesh, MICROBATCHES)(
                model, torch.from_numpy(tokens).to(dev))
        finally:
            ttf.moe_ffn_stats = real
        routing = chip_smoke._gather_routing(model, choices, mesh, rank == 0, MICROBATCHES)
        whole = {n: g.float().cpu().numpy()
                 for n, g in ttf.gather_params(grads, cfg, mesh).items()}
        results.put((rank, float(loss), (whole, routing.cpu().numpy()) if rank == 0 else None,
                     mesh.axis("pp").transport(dev), fa.flash_fwd.launches))
    except BaseException:  # noqa: BLE001 - reported to the parent
        import traceback

        results.put((rank, traceback.format_exc()))
        raise


@pytest.mark.cuda
def test_pp2_ep2_across_four_cards_over_nccl():
    """Four processes, a card each, form ``{"pp": 2, "ep": 2}`` over NCCL;
    the pipelined bf16 MoE model's loss and gathered gradients against the
    one-device flash model and the f32 model with dense attention on the
    same weights, each microbatch on its own and on the pp x ep model's
    expert choices (phase 12's references, ``chip_smoke._pp_step0_refs``),
    with phase 10's bounds (``chip_smoke.hsdp_accuracy``)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    import chip_smoke
    from torchft_tpu_torch import _kernels

    _kernels.build()  # once, before the four processes load it
    cfg = ttf.TransformerConfig(dtype=torch.bfloat16, attn_impl="flash", remat=True,
                                **CUDA_CFG)
    model = ttf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tree = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 128))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    addr, listener = multihost.coordinator_listener()
    procs = [ctx.Process(target=_nccl_rank, args=(r, (addr, listener if r == 0 else None),
                                                  (tree, tokens), results),
                         daemon=True) for r in range(SIZE)]
    for p in procs:
        p.start()
    listener.close()  # rank 0 holds its own copy
    got = {}
    try:
        while len(got) < SIZE:
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
    assert all(got[r][2] == "nccl" and got[r][3] > 0 for r in range(SIZE))
    assert len({got[r][0] for r in range(SIZE)}) == 1  # the loss, on every rank
    grads, routing = got[0][1]
    dev = torch.device("cuda", 0)
    refs, margins = chip_smoke._pp_step0_refs(
        {n: torch.from_numpy(v).to(dev) for n, v in tree.items()}, cfg,
        torch.from_numpy(tokens).to(dev), "cuda", torch.from_numpy(routing).to(dev),
        MICROBATCHES)
    checks = chip_smoke.hsdp_accuracy(
        (got[0][0], {n: torch.from_numpy(g) for n, g in grads.items()}),
        {k: (loss, {n: g.cpu() for n, g in g_.items()}) for k, (loss, g_) in refs.items()})
    assert margins["share"] <= chip_smoke.PP_TIE_SHARE, margins
    assert not checks["failed"], checks
