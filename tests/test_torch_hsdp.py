"""The port's transformer under fsdp and tp (HSDP's inner mesh) against the
JAX package's, on the CPU.

A tiny f32 2-layer config (d_model 32, 4 query / 2 KV heads, vocab 64,
T 16); the JAX package's initial weights move into each rank's model
through ``convert.params_from_jax(..., mesh=...)``, which keeps the rank's
shards.  Thread ranks with raw gloo groups form the inner mesh
(``ft_init_device_mesh`` over ``local_worlds``); each takes the group's
whole ``[B, T]`` token array and returns the global loss and its shards'
gradients, which ``convert.gather_to_jax`` puts back together.  JAX runs
``make_grad_step`` (``jax.value_and_grad`` of the sharded ``forward``) on
``shard_params`` over a mesh of the same shape on its virtual CPU devices.
Tolerance ``atol=5e-5, rtol=1e-4``, tests/test_ulysses.py's for the
transformer; the shards themselves are compared bit for bit.
"""

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from torchft_tpu.models import transformer as jtf
from torchft_tpu_torch import convert
from torchft_tpu_torch.models import transformer as ttf
from torchft_tpu_torch.parallel import multihost
from torchft_tpu_torch.parallel.device_mesh import ft_init_device_mesh

TOL = dict(atol=5e-5, rtol=1e-4)
SHAPE = dict(
    vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
    n_layers=2, max_seq_len=16,
)
#: inner mesh name -> (shape, attention route); cp shards the sequence, so
#: its meshes take ring or Ulysses attention (on the tp-local heads under tp)
MESHES = {
    "fsdp2": ({"fsdp": 2}, "dense"),
    "tp2": ({"tp": 2}, "dense"),
    "fsdp2-tp2": ({"fsdp": 2, "tp": 2}, "dense"),
    "dp2-tp2": ({"dp": 2, "tp": 2}, "dense"),
    "fsdp2-cp2": ({"fsdp": 2, "cp": 2}, "ring"),
    "tp2-cp2": ({"tp": 2, "cp": 2}, "ring"),
    "tp2-cp2-ulysses": ({"tp": 2, "cp": 2}, "ulysses"),
}


def _configs(attn_impl="dense", **kw):
    shape = dict(SHAPE, **kw)
    return (
        jtf.TransformerConfig(dtype=jnp.float32, attn_impl=attn_impl, remat=False, **shape),
        ttf.TransformerConfig(dtype=torch.float32, attn_impl=attn_impl, remat=False, **shape),
    )


@functools.lru_cache(maxsize=None)
def _setup(**kw):
    jcfg, _ = _configs(**kw)
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    return params, tree, tokens


def _jax_mesh(shape):
    n = int(np.prod(list(shape.values())))
    devices = np.array(jax.devices()[:n]).reshape(tuple(shape.values()))
    return Mesh(devices, tuple(shape))


def run_mesh(shape, body):
    """``body(rank, mesh)`` on thread ranks forming the inner mesh
    ``shape``."""
    n = int(np.prod(list(shape.values())))
    worlds = multihost.local_worlds(n, timeout=30.0)

    def rank(r):
        mesh = ft_init_device_mesh(None, shape, groups=worlds[r], device="cpu").mesh
        return body(r, mesh)

    return multihost.run_ranks(rank, n, timeout=60.0)


def _port_step(tcfg, tree, tokens, shape):
    """Each rank's loss, gradients and parameters (its shards)."""
    def body(r, mesh):
        model = convert.params_from_jax(tree, tcfg, device="cpu", mesh=mesh)
        loss, grads = ttf.make_grad_step(tcfg, mesh)(model, torch.from_numpy(tokens).long())
        return float(loss), grads, model

    return run_mesh(shape, body)


def _check_against_jax(jcfg, tcfg, params, tree, tokens, shape):
    mesh = _jax_mesh(shape)
    sharded = jtf.shard_params(params, mesh, jcfg)
    j_loss, j_grads = jtf.make_grad_step(jcfg, mesh)(sharded, jnp.asarray(tokens))
    ranks = _port_step(tcfg, tree, tokens, shape)
    for loss, _, _ in ranks:
        np.testing.assert_allclose(loss, float(j_loss), **TOL)
    got = jax.tree_util.tree_leaves(
        convert.gather_to_jax([g for _, g, _ in ranks], tcfg, shape))
    want = jax.tree_util.tree_leaves(j_grads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    return ranks


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_loss_and_gradients_match_jax(mesh_name):
    """The port's loss and its ranks' gradients, gathered, against
    ``jax.value_and_grad`` of the sharded ``forward`` on the same mesh.
    Ranks holding the same block of a leaf hold the same bits."""
    shape, attn_impl = MESHES[mesh_name]
    params, tree, tokens = _setup()
    jcfg, tcfg = _configs(attn_impl)
    ranks = _check_against_jax(jcfg, tcfg, params, tree, tokens, shape)
    specs = ttf.param_specs(tcfg, shape)
    # the norms are whole on every rank: their gradients agree bitwise
    for name, spec in specs.items():
        if spec == (None,):
            for _, grads, _ in ranks[1:]:
                assert torch.equal(grads[name], ranks[0][1][name]), name


@pytest.mark.parametrize("mesh_name", [n for n in MESHES if not n.endswith("ulysses")])
def test_each_ranks_shards_equal_jax_shard_params(mesh_name):
    """Rank r's block of every leaf is, bit for bit, the block JAX's
    ``shard_params`` puts on the device at mesh position r."""
    shape, _ = MESHES[mesh_name]
    params, tree, _ = _setup()
    jcfg, tcfg = _configs()
    mesh = _jax_mesh(shape)
    sharded = jtf.shard_params(params, mesh, jcfg)
    position = {d: r for r, d in enumerate(mesh.devices.reshape(-1))}
    models = run_mesh(shape, lambda r, m: convert.params_from_jax(
        tree, tcfg, device="cpu", mesh=m))
    for r, model in enumerate(models):
        mine = jax.tree_util.tree_leaves_with_path(convert.params_to_jax(model, tcfg))
        leaves = dict(jax.tree_util.tree_leaves_with_path(sharded))
        for path, got in mine:
            (shard,) = [s for s in leaves[path].addressable_shards if position[s.device] == r]
            np.testing.assert_array_equal(got, np.asarray(shard.data), err_msg=str(path))
    # and the shards cover the whole leaf: gather_to_jax puts them back
    whole = convert.gather_to_jax(models, tcfg, shape)
    for a, b in zip(jax.tree_util.tree_leaves(whole), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_gather_params_puts_each_ranks_shards_back_whole():
    """``gather_params``, collective, is ``shard_params``' inverse: every
    rank of ``{"fsdp": 2, "tp": 2}`` gets each leaf whole, bit for bit; a
    rank with ``keep=False`` takes part but holds nothing."""
    _, tree, _ = _setup()
    _, tcfg = _configs()
    shape, _ = MESHES["fsdp2-tp2"]

    def body(r, mesh):
        model = convert.params_from_jax(tree, tcfg, device="cpu", mesh=mesh)
        named = dict(model.named_parameters())
        return (ttf.gather_params(named, tcfg, mesh),
                ttf.gather_params(named, tcfg, mesh, keep=r == 0))

    ranks = run_mesh(shape, body)
    for r, (whole, kept) in enumerate(ranks):
        got = jax.tree_util.tree_leaves(convert.params_to_jax(whole, tcfg))
        for a, b in zip(got, jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(a, b)
        assert (kept.keys() == whole.keys()) if r == 0 else kept == {}


def test_row_parallel_product_gradients_match_autograd():
    """The row-parallel partial product takes compute-dtype operands to an
    f32 product; its hand-written backward gives what autograd of the f32
    product gives, rounded to the operands' dtypes."""
    rng = np.random.default_rng(3)
    x0 = torch.from_numpy(rng.standard_normal((2, 5, 24), np.float32)).bfloat16()
    w0 = torch.from_numpy(rng.standard_normal((16, 24), np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((2, 5, 16), np.float32)).bfloat16().float()
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    out = ttf._RowProduct.apply(x, w)
    out.backward(g)
    xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    want = torch.nn.functional.linear(xr.float(), wr.float())
    want.backward(g)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    for a, b in ((x, xr), (w, wr)):
        assert a.grad.dtype == torch.bfloat16
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


def test_tp2_with_three_kv_heads_expands_them_as_jax_does():
    """n_kv_heads = 3 does not split over tp = 2: a rank's wk/wv shard is
    1.5 heads, so the port gathers wk and wv over tp and picks the KV head
    of each of its query heads (JAX's ``_expand_kv_for_tp``)."""
    kw = dict(d_model=48, n_heads=6, n_kv_heads=3)
    params, tree, tokens = _setup(**kw)
    jcfg, tcfg = _configs(**kw)
    _check_against_jax(jcfg, tcfg, params, tree, tokens, {"tp": 2})


def test_fsdp_tp_under_full_remat_changes_nothing():
    """Full remat gathers each block's weights again in the recompute (and
    repeats its tp psums, in the same order on every rank); the values are
    those without remat."""
    _, tree, tokens = _setup()
    _, tcfg = _configs()
    shape, _ = MESHES["fsdp2-tp2"]
    plain = _port_step(tcfg, tree, tokens, shape)
    remat = _port_step(dataclasses.replace(tcfg, remat=True, remat_policy="full"),
                       tree, tokens, shape)
    for a, b in zip(plain, remat):
        assert a[0] == b[0]
        for name in a[1]:
            torch.testing.assert_close(b[1][name], a[1][name], rtol=0, atol=0)


def test_two_groups_of_fsdp2_tp2_train_bitwise_equal_under_managers():
    """The port of tests/test_hsdp_integ.py's two replica groups x inner
    ``{"fsdp": 2, "tp": 2}``: eight thread ranks, each with its own Manager
    (group_rank = its rank in the group), whose state is its shards and
    their AdamW state; the FT allreduce averages rank r's shard gradients
    with rank r of the other group.  Three committed steps on different
    tokens per group leave rank r of both groups bitwise equal."""
    from torchft_tpu_torch import (
        DistributedDataParallel,
        Manager,
        OptimizerWrapper,
        ProcessGroupTCP,
        module_grads,
    )
    from torchft_tpu_torch.coordination import LighthouseServer, StoreServer

    _, tcfg = _configs()
    lighthouse = LighthouseServer(min_replicas=2, join_timeout_ms=100,
                                  heartbeat_timeout_ms=5000)
    stores = [StoreServer() for _ in range(2)]
    worlds = [multihost.local_worlds(4) for _ in range(2)]
    inner, _ = MESHES["fsdp2-tp2"]

    def run(gid, r):
        model = ttf.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
        opt = None
        manager = Manager(
            pg=ProcessGroupTCP(timeout=30.0), min_replica_size=2,
            load_state_dict=lambda sd: None, state_dict=lambda: {},
            lighthouse_addr=lighthouse.address(), replica_id=f"hsdp{gid}",
            group_rank=r, group_world_size=4, store_addr=stores[gid].address(),
            use_async_quorum=False, timeout=30.0, quorum_timeout=30.0,
            init_sync=False,
        )
        try:
            fmesh = ft_init_device_mesh(manager, inner, groups=worlds[gid][r], device="cpu")
            ttf.shard_params(model, fmesh.mesh)
            opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
            grad_step = ttf.make_grad_step(tcfg, fmesh.mesh)
            optim = OptimizerWrapper(manager, opt)
            ddp = DistributedDataParallel(manager)
            losses = []
            while manager.current_step() < 3:
                optim.zero_grad()
                step = manager.current_step()
                tokens = torch.randint(0, tcfg.vocab_size, (4, 16), generator=torch.Generator()
                                       .manual_seed(100 * gid + step))
                loss, _ = grad_step(model, tokens)
                avg = ddp.allreduce_gradients(module_grads(model)).wait(timeout=30)
                assert optim.step(model, avg)
                losses.append(float(loss))
            state = {n: p.detach().clone() for n, p in model.named_parameters()}
            for n, p in model.named_parameters():
                for k, v in opt.state[p].items():
                    state[f"{n}/{k}"] = v.clone()
            return manager.current_step(), losses, state
        finally:
            manager.shutdown()

    results = {}

    def group(gid):
        results[gid] = multihost.run_ranks(lambda r: run(gid, r), 4, timeout=90.0)

    threads = [threading.Thread(target=group, args=(g,), daemon=True) for g in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        lighthouse.shutdown()
        for s in stores:
            s.shutdown()
    assert sorted(results) == [0, 1]
    for r in range(4):
        (s0, l0, a), (s1, l1, b) = results[0][r], results[1][r]
        assert s0 == s1 == 3 and all(np.isfinite(l0 + l1))
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), r
        # a rank holds shards: the tied embedding's block is [V/tp, d/fsdp]
        assert tuple(a["embed"].shape) == (32, 16)
    # the groups trained on different tokens; a group's ranks agree on the loss
    assert all(results[0][r][1] == results[0][0][1] for r in range(4))
    assert results[0][0][1] != results[1][0][1]
