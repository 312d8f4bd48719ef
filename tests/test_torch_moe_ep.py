"""The port's MoE transformer under expert parallelism, and remat "dots"
under context parallelism, against the JAX package's, on the CPU.

Routing is held to JAX's exactly: each rank routes its own tokens (its
rows, and its sequence chunk under cp) with the global statistics
(``global_counts``, ``counts_before``), given the global logits and their
softmax; its experts, slots, kept mask and gates must be the JAX package's
routing of the whole batch at those tokens, capacity from the global count.
The whole model (tiny f32 2-layer, 4 experts, top-2, capacity 1.25) runs
``make_grad_step`` on thread ranks forming the inner mesh against JAX's
sharded ``make_grad_step`` on a mesh of the same shape, after asserting
that no routing sits near a tie.  Tolerances: the loss to 2e-5 relative
(tests/test_moe.py), gradients ``atol=5e-5, rtol=1e-4``
(tests/test_torch_hsdp.py).  Every rank group runs under ``run_ranks``' 60
s limit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from torchft_tpu.models import transformer as jtf
from torchft_tpu_torch import convert
from torchft_tpu_torch.models import moe as tmoe
from torchft_tpu_torch.models import transformer as ttf
from torchft_tpu_torch.parallel import multihost
from torchft_tpu_torch.parallel.device_mesh import ft_init_device_mesh

TOL = dict(atol=5e-5, rtol=1e-4)
SHAPE = dict(
    vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, d_ff=48,
    n_layers=2, max_seq_len=16, n_experts=4, moe_top_k=2,
    moe_capacity_factor=1.25,
)
#: MoE meshes of tests/test_torch_moe_ep and the JAX package's MoE tests
#: (``(dp, tp, ep)`` from tests/test_moe.py's sharded transformer)
MESHES = {
    "ep2": ({"ep": 2}, "dense"),
    "ep2-fsdp2": ({"fsdp": 2, "ep": 2}, "dense"),
    "dp2-ep2": ({"dp": 2, "ep": 2}, "dense"),
    "cp2-ep2": ({"ep": 2, "cp": 2}, "ring"),
    "dp2-tp2-ep2": ({"dp": 2, "tp": 2, "ep": 2}, "dense"),
}


def run_mesh(shape, body):
    n = int(np.prod(list(shape.values())))
    worlds = multihost.local_worlds(n, timeout=30.0)

    def rank(r):
        mesh = ft_init_device_mesh(None, shape, groups=worlds[r], device="cpu").mesh
        return body(r, mesh)

    return multihost.run_ranks(rank, n, timeout=60.0)


def _jax_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(shape.values())), tuple(shape))


def _rows_and_chunk(mesh, b, t):
    """This rank's rows (``dp`` x ``fsdp`` x ``ep`` blocks) and chunk."""
    block, blocks = 0, 1
    for name in ttf.BATCH_AXES:
        block = block * mesh.axis_size(name) + mesh.axis_index(name)
        blocks *= mesh.axis_size(name)
    bl, tl = b // blocks, t // mesh.axis_size("cp")
    start = mesh.axis_index("cp") * tl
    return slice(block * bl, (block + 1) * bl), slice(start, start + tl)


# ---------------------------------------------------------------------------
# routing with the global statistics
# ---------------------------------------------------------------------------


def _jax_routing(logits, ne, k, cap):
    """The JAX package's routing (torchft_tpu/models/moe.py:111-138) of the
    whole batch's logits (tests/test_torch_moe.py's)."""
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_idx = jax.lax.top_k(logits, k)
    masks = [jax.nn.one_hot(top_idx[:, kk], ne, dtype=jnp.float32) for kk in range(k)]
    gates = jnp.stack([(probs * m).sum(axis=-1) for m in masks], axis=0)
    gates = gates / jnp.maximum(gates.sum(axis=0, keepdims=True), 1e-9)
    prev = jnp.zeros((ne,), jnp.int32)
    positions = []
    for kk in range(k):
        imask = masks[kk].astype(jnp.int32)
        pos = jnp.cumsum(imask, axis=0) - 1 + prev[None, :]
        prev = prev + imask.sum(axis=0)
        positions.append(jnp.take_along_axis(pos, top_idx[:, kk:kk + 1], axis=1)[:, 0])
    position = np.asarray(jnp.stack(positions, axis=1))
    return np.asarray(top_idx), position, position < cap, np.asarray(gates)


def _logit_cases(b, t, ne):
    rng = np.random.default_rng(0)
    yield "random", rng.standard_normal((b, t, ne)).astype(np.float32)
    yield "some_tied", rng.integers(0, 3, (b, t, ne)).astype(np.float32)
    skew = rng.standard_normal((b, t, ne)).astype(np.float32)
    skew[..., 0] += 3.0  # capacity drops
    yield "skewed", skew


@pytest.mark.parametrize("factor", [0.25, 1.25])
@pytest.mark.parametrize("case", ["random", "some_tied", "skewed"])
@pytest.mark.parametrize("mesh_name", ["ep2", "dp2-ep2", "cp2-ep2"])
def test_routing_with_global_statistics_is_exact(mesh_name, case, factor):
    """Each rank's tokens take the slots JAX's routing of the whole batch
    gives them: same experts (ties included), positions, kept mask and
    gates; capacity from the global count, so drops fall where they fall
    on one device."""
    shape = MESHES[mesh_name][0]
    b, t, ne, k = 4, 16, 8, 2
    logits = dict(_logit_cases(b, t, ne))[case]
    flat = logits.reshape(-1, ne)
    cap = max(1, int(np.ceil(factor * b * t * k / ne)))
    probs = np.array(jax.nn.softmax(jnp.asarray(flat), axis=-1)).reshape(b, t, ne)
    want = [a.reshape(b, t, -1) if a.ndim == 2 and a.shape[0] == b * t else a
            for a in _jax_routing(jnp.asarray(flat), ne, k, cap)]
    gates = want[3].reshape(k, b, t)

    def body(r, mesh):
        rows, chunk = _rows_and_chunk(mesh, b, t)
        group = ttf._moe_group(mesh, chunk_routing=False)
        local = torch.from_numpy(np.ascontiguousarray(logits[rows, chunk]).reshape(-1, ne))
        lprobs = torch.from_numpy(np.ascontiguousarray(probs[rows, chunk]).reshape(-1, ne))
        n_rows = logits[rows].shape[0]
        counts, blocks = tmoe.global_counts(
            tmoe.block_counts(tmoe._top_k(local, k), ne, n_rows), group)
        assert counts.shape[0] * (local.shape[0] // n_rows) == b * t
        got = tmoe.route(local, lprobs, ne, k, cap, tmoe.counts_before(counts, blocks))
        return rows, chunk, got

    for rows, chunk, got in run_mesh(shape, body):
        n = got.top_idx.shape[0]
        np.testing.assert_array_equal(got.top_idx.numpy(), want[0][rows, chunk].reshape(n, k))
        np.testing.assert_array_equal(got.position.numpy(), want[1][rows, chunk].reshape(n, k))
        np.testing.assert_array_equal(got.kept.numpy(), want[2][rows, chunk].reshape(n, k))
        np.testing.assert_array_equal(got.gates.numpy(), gates[:, rows, chunk].reshape(k, n))
    if factor < 1:
        assert not want[2].all(), "the small capacity should drop choices"


# ---------------------------------------------------------------------------
# the MoE transformer under ep
# ---------------------------------------------------------------------------


def _configs(attn_impl, **kw):
    shape = dict(SHAPE, **kw)
    return (
        jtf.TransformerConfig(dtype=jnp.float32, attn_impl=attn_impl, remat=False, **shape),
        ttf.TransformerConfig(dtype=torch.float32, attn_impl=attn_impl, remat=False, **shape),
    )


@functools.lru_cache(maxsize=None)
def _setup(**kw):
    jcfg, _ = _configs("dense", **kw)
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    return params, tree, tokens


def _jax_step(jcfg, params, tokens, shape):
    mesh = _jax_mesh(shape)
    return jtf.make_grad_step(jcfg, mesh)(jtf.shard_params(params, mesh, jcfg),
                                           jnp.asarray(tokens))


def _record_router_margins(monkeypatch):
    margins = []
    real = ttf.moe_ffn_stats

    def spy(h, params, cfg, *group):
        logits = h.detach().reshape(-1, h.shape[-1]).float() @ params["router"].detach().float()
        top = torch.sort(logits, dim=-1, descending=True).values[:, : cfg.top_k + 1]
        margins.append(float((top[:, :-1] - top[:, 1:]).min()))
        return real(h, params, cfg, *group)

    monkeypatch.setattr(ttf, "moe_ffn_stats", spy)
    return margins


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_moe_loss_and_grads_match_jax_sharded(mesh_name, monkeypatch):
    """The loss (nll + aux over the global batch) and every gradient,
    gathered from the ranks, against ``jax.value_and_grad`` of the sharded
    ``loss_fn`` on the same mesh; ranks of one ``ep`` index hold the same
    expert shards' gradients, every rank the same router gradient."""
    shape, attn_impl = MESHES[mesh_name]
    params, tree, tokens = _setup()
    jcfg, tcfg = _configs(attn_impl)
    j_loss, j_grads = _jax_step(jcfg, params, tokens, shape)
    margins = _record_router_margins(monkeypatch)

    def body(r, mesh):
        model = convert.params_from_jax(tree, tcfg, device="cpu", mesh=mesh)
        loss, grads = ttf.make_grad_step(tcfg, mesh)(model, torch.from_numpy(tokens).long())
        return float(loss), grads

    ranks = run_mesh(shape, body)
    # precondition: no routing near a tie (the router inputs agree with
    # JAX's to ~1e-6 in f32 through two blocks)
    assert min(margins) > 1e-4, min(margins)
    for loss, grads in ranks:
        np.testing.assert_allclose(loss, float(j_loss), rtol=2e-5)
        assert torch.equal(grads["blocks.0.router"], ranks[0][1]["blocks.0.router"])
    got = jax.tree_util.tree_leaves(convert.gather_to_jax([g for _, g in ranks], tcfg, shape))
    want = jax.tree_util.tree_leaves(j_grads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_moe_under_ep_reports_the_global_aux_and_dropped_share():
    """Each MoE block's ``moe_stats`` under ep are the global batch's: the
    same on every rank, and those of the one-device model on the whole
    batch."""
    _, tree, tokens = _setup()
    _, tcfg = _configs("dense")
    one = convert.params_from_jax(tree, tcfg, device="cpu")
    with torch.no_grad():
        one(torch.from_numpy(tokens).long())
    want = [(float(b.moe_stats["aux"]), float(b.moe_stats["dropped"])) for b in one.blocks]

    def body(r, mesh):
        model = convert.params_from_jax(tree, tcfg, device="cpu", mesh=mesh)
        rows, _ = _rows_and_chunk(mesh, *tokens.shape)
        with torch.no_grad():
            model(torch.from_numpy(tokens[rows]).long(), mesh=mesh)
        return [(float(b.moe_stats["aux"]), float(b.moe_stats["dropped"])) for b in model.blocks]

    for got in run_mesh({"ep": 2}, body):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert any(d > 0 for _, d in want), "capacity 1.25 should drop some choices here"


# ---------------------------------------------------------------------------
# remat "dots" under cp
# ---------------------------------------------------------------------------

DENSE = dict(vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, n_layers=2,
             max_seq_len=256)
#: attention route -> (attn_impl, T): ring's plain tile body (T_local 32),
#: Ulysses, and ring on flash tiles (T_local 128; the port alone)
DOTS_ROUTES = {"ring-plain": ("ring", 64), "ulysses": ("ulysses", 64),
               "ring-flash": ("ring", 256)}


def _exchange_bytes(stats):
    return sum(v for k, v in stats.items() if k in ("shift_bytes", "all_to_all_bytes"))


@pytest.mark.parametrize("route", list(DOTS_ROUTES))
def test_remat_dots_under_cp_matches_jax_and_exchanges_no_more_bytes(route):
    """``remat_policy="dots"`` over ``cp = 2``: the loss and gradients are
    JAX's ``dots_saveable`` ones (ring's plain body and Ulysses; the flash
    ring against the port without remat), and the step moves the bytes a
    step without remat moves, where full remat repeats the forward's
    exchanges: the recompute keeps the exchanges' outputs."""
    impl, t = DOTS_ROUTES[route]
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, attn_impl=impl, remat=True,
                                 remat_policy="dots", **DENSE)
    tcfg = ttf.TransformerConfig(dtype=torch.float32, attn_impl=impl, remat=True,
                                 remat_policy="dots", **DENSE)
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tokens = np.random.default_rng(1).integers(0, 256, (2, t)).astype(np.int32)

    def body(r, mesh):
        model = convert.params_from_jax(tree, tcfg, device="cpu")
        out = {}
        for name, cfg in (("none", dataclasses.replace(tcfg, remat=False)),
                          ("full", dataclasses.replace(tcfg, remat_policy="full")),
                          ("dots", tcfg)):
            model.cfg = cfg
            for block in model.blocks:
                block.cfg = cfg
            before = mesh.stats()
            loss, grads = ttf.make_grad_step(cfg, mesh)(model, torch.from_numpy(tokens).long())
            after = mesh.stats()
            out[name] = (float(loss), {n: g.clone() for n, g in grads.items()},
                         _exchange_bytes(after) - _exchange_bytes(before))
        return out

    ranks = run_mesh({"cp": 2}, body)
    if route != "ring-flash":
        j_loss, j_grads = jtf.make_grad_step(jcfg, _jax_mesh({"cp": 2}))(
            params, jnp.asarray(tokens))
        want = jax.tree_util.tree_leaves(j_grads)
    for out in ranks:
        loss, grads, moved = out["dots"]
        if route != "ring-flash":
            np.testing.assert_allclose(loss, float(j_loss), **TOL)
            got = jax.tree_util.tree_leaves(convert.params_to_jax(grads, tcfg))
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, np.asarray(b), **TOL)
        # dots changes no value: the same bits as full remat and none
        for other in ("none", "full"):
            assert loss == out[other][0]
            for n in grads:
                assert torch.equal(grads[n], out[other][1][n]), (other, n)
        assert moved == out["none"][2] > 0
        assert out["full"][2] > moved
