"""The port's MoE layer and MoE transformer against the JAX package's, on
the CPU.

Routing is held to the JAX package exactly, on the same f32 logits and
their softmax (no two libraries' ``exp`` agree to the bit, so the softmax
itself is held to a few ulps): the expert choices (ties included), each
choice's position in its expert, the kept mask and the gates.  The whole layer is held at a stated tolerance on
inputs whose top-k margin the test asserts to be far above the error of
the two packages' f32 router products (they sum in another order, so a
near-tie could route differently; the margin rules that out rather than a
chosen seed).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu.models import moe as jmoe
from torchft_tpu.models import transformer as jtf
from torchft_tpu_torch import convert
from torchft_tpu_torch.models import moe as tmoe
from torchft_tpu_torch.models import transformer as ttf

F32_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16 experts: both packages round each bf16 product's output to bf16
# (2^-8 relative), after summing in f32 in different orders
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
# the MoE transformer: tests/test_torch_transformer.py's tolerance
TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_routing(logits, ne, k, cap):
    """The JAX package's routing (torchft_tpu/models/moe.py:111-138) on
    given logits, returning what the port's ``route`` returns."""
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


def _logit_cases():
    rng = np.random.default_rng(0)
    yield "random", rng.standard_normal((64, 8)).astype(np.float32)
    # the zero router: every logit ties
    yield "all_tied", np.zeros((64, 8), np.float32)
    # few distinct values: ties inside and across the top k
    yield "some_tied", rng.integers(0, 3, (64, 8)).astype(np.float32)
    # skewed toward expert 0: capacity drops
    skew = rng.standard_normal((64, 8)).astype(np.float32)
    skew[:, 0] += 3.0
    yield "skewed", skew


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("factor", [0.25, 1.25])
@pytest.mark.parametrize("case", [c for c, _ in _logit_cases()])
def test_routing_on_shared_logits_is_exact(case, factor, top_k):
    logits = dict(_logit_cases())[case]
    n, ne = logits.shape
    cap = max(1, int(np.ceil(factor * n * top_k / ne)))
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    np.testing.assert_allclose(
        torch.softmax(torch.from_numpy(logits), dim=-1).numpy(), probs, rtol=1e-6, atol=0
    )
    got = tmoe.route(torch.from_numpy(logits), torch.from_numpy(probs), ne, top_k, cap)
    want = _jax_routing(jnp.asarray(logits), ne, top_k, cap)
    np.testing.assert_array_equal(got.top_idx.numpy(), want[0])
    np.testing.assert_array_equal(got.position.numpy(), want[1])
    np.testing.assert_array_equal(got.kept.numpy(), want[2])
    np.testing.assert_array_equal(got.gates.numpy(), want[3])
    if factor < 1 and case != "all_tied":
        assert not got.kept.all(), "the small capacity should drop choices"


_JAX_MOE = {}


def _jax_moe_ffn(jcfg):
    """JAX ``moe_ffn`` jitted once per config."""
    if jcfg not in _JAX_MOE:
        _JAX_MOE[jcfg] = jax.jit(lambda a, p: jmoe.moe_ffn(a, p, jcfg))
    return _JAX_MOE[jcfg]


def _cfgs(dtype, **kw):
    base = dict(d_model=16, d_ff=32, n_experts=4, top_k=2, capacity_factor=1.25)
    base.update(kw)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return jmoe.MoEConfig(dtype=jdt, **base), tmoe.MoEConfig(dtype=dtype, **base)


def _setup(jcfg, b=2, t=16, seed=0):
    params = jmoe.init_moe_params(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed + 1).standard_normal((b, t, jcfg.d_model)).astype(np.float32)
    return jax.tree_util.tree_map(np.asarray, params), x


def _tparams(params, requires_grad=False):
    return {k: torch.tensor(v, requires_grad=requires_grad) for k, v in params.items()}


def _assert_margin(x, router, top_k):
    """Precondition: every token's top k + 1 logits are apart by far more
    than the two packages' f32 router products differ."""
    flat = x.reshape(-1, x.shape[-1]).astype(np.float32)
    port = (torch.from_numpy(flat) @ torch.from_numpy(router)).numpy()
    ref = np.asarray(jnp.asarray(flat) @ jnp.asarray(router))
    err = float(np.abs(port - ref).max())
    top = -np.sort(-port, axis=-1)[:, : top_k + 1]
    margin = float(np.diff(-top, axis=-1).min())
    assert margin > 100 * max(err, 1e-7), (margin, err)


# capacity 4.0 (no drops) is held through the references below
@pytest.mark.parametrize("factor", [0.5, 1.25])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_matches_jax(dtype, factor):
    jcfg, tcfg = _cfgs(dtype, capacity_factor=factor)
    params, x = _setup(jcfg)
    _assert_margin(x, params["router"], jcfg.top_k)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    tx = torch.from_numpy(x).to(dtype)
    y, aux = tmoe.moe_ffn(tx, _tparams(params), tcfg)
    jy, jaux = _jax_moe_ffn(jcfg)(jx, params)
    assert y.dtype == dtype and y.shape == tx.shape
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(float(aux), float(jaux), **F32_TOL)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_the_references_without_drops(top_k):
    jcfg, tcfg = _cfgs(torch.float32, top_k=top_k, capacity_factor=4.0)
    params, x = _setup(jcfg)
    _assert_margin(x, params["router"], top_k)
    tx = torch.from_numpy(x)
    y, _ = tmoe.moe_ffn(tx, _tparams(params), tcfg)
    ref = tmoe.moe_ffn_reference(tx, _tparams(params), tcfg)
    jref = jmoe.moe_ffn_reference(jnp.asarray(x), params, jcfg)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), **F32_TOL)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), **F32_TOL)


def test_capacity_drops_pass_through_as_zero():
    jcfg, tcfg = _cfgs(torch.float32, capacity_factor=0.1)
    params, x = _setup(jcfg)
    tx = torch.from_numpy(x)
    y, aux, dropped = tmoe.moe_ffn_stats(tx, _tparams(params), tcfg)
    full, full_aux = tmoe.moe_ffn(tx, _tparams(params), dataclasses.replace(tcfg, capacity_factor=4.0))
    assert torch.isfinite(y).all() and 0.0 < float(dropped) < 1.0
    assert y.abs().sum() < full.abs().sum()
    assert float(aux) == float(full_aux)  # drops leave the aux alone
    # a token whose every choice was dropped comes out exactly zero
    n = x.shape[0] * x.shape[1]
    cap = tmoe._capacity(n, tcfg)
    logits = tx.reshape(n, -1) @ torch.from_numpy(params["router"])
    kept = tmoe.route(logits, logits.softmax(-1), tcfg.n_experts, tcfg.top_k, cap).kept
    none_kept = ~kept.any(dim=1)
    assert none_kept.any()
    assert (y.reshape(n, -1)[none_kept] == 0).all()


def test_aux_loss_is_one_for_a_uniform_router():
    jcfg, tcfg = _cfgs(torch.float32)
    params, x = _setup(jcfg)
    params = dict(params, router=np.zeros_like(params["router"]))
    y, aux = tmoe.moe_ffn(torch.from_numpy(x), _tparams(params), tcfg)
    jy, jaux = _jax_moe_ffn(jcfg)(jnp.asarray(x), params)
    np.testing.assert_allclose(float(aux), 1.0, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)


def test_gradients_to_router_and_experts_match_jax():
    jcfg, tcfg = _cfgs(torch.float32)
    params, x = _setup(jcfg)
    _assert_margin(x, params["router"], jcfg.top_k)

    def jloss(p, xx):
        y, aux = jmoe.moe_ffn(xx, p, jcfg)
        return (y ** 2).mean() + 0.01 * aux

    jgrads, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x)
    )
    tp = _tparams(params, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    y, aux = tmoe.moe_ffn(tx, tp, tcfg)
    ((y ** 2).mean() + 0.01 * aux).backward()
    for name in ("router", "w_gate", "w_up", "w_down"):
        g = tp[name].grad.numpy()
        assert np.abs(g).sum() > 0, f"no gradient through {name}"
        np.testing.assert_allclose(g, np.asarray(jgrads[name]), **F32_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **F32_TOL)


def test_stacked_init_shapes_and_statistics():
    _, tcfg = _cfgs(torch.float32, d_model=64, d_ff=128)
    p = tmoe.init_moe_params(torch.Generator().manual_seed(0), tcfg, n_layers=3, device="cpu")
    assert p["router"].shape == (3, 64, 4)
    assert p["w_gate"].shape == p["w_up"].shape == (3, 4, 64, 128)
    assert p["w_down"].shape == (3, 4, 128, 64)
    for name, fan_in in (("w_gate", 64), ("w_down", 128)):
        np.testing.assert_allclose(float(p[name].std()), fan_in ** -0.5, rtol=0.05)


# ---------------------------------------------------------------------------
# the MoE transformer
# ---------------------------------------------------------------------------

SHAPE = dict(
    vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    n_layers=2, max_seq_len=64, n_experts=4,
)


def _tf_configs(remat, policy):
    return (
        jtf.TransformerConfig(dtype=jnp.float32, attn_impl="dense", remat=remat,
                              remat_policy=policy, **SHAPE),
        ttf.TransformerConfig(dtype=torch.float32, attn_impl="dense", remat=remat,
                              remat_policy=policy, **SHAPE),
    )


@pytest.fixture(scope="module")
def tf_setup():
    """The JAX model's weights, tokens, and its logits, aux, loss and
    gradients (computed once, without remat: a remat policy changes what
    the backward recomputes, not the values the port is held to)."""
    jcfg, _ = _tf_configs(False, "full")
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tokens = np.random.default_rng(1).integers(0, 256, (2, 64)).astype(np.int32)
    jt = jnp.asarray(tokens)
    logits, aux = jax.jit(lambda p, t: jtf.forward(p, t, jcfg, return_aux=True))(params, jt)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, t: jtf.loss_fn(p, t, jcfg)))(params, jt)
    ref = dict(logits=np.asarray(logits), aux=float(aux), loss=float(loss), grads=grads)
    return tree, tokens, ref


def _record_router_margins(monkeypatch):
    margins = []
    real = ttf.moe_ffn_stats

    def spy(h, params, cfg):
        logits = h.detach().reshape(-1, h.shape[-1]).float() @ params["router"].detach().float()
        top = torch.sort(logits, dim=-1, descending=True).values[:, : cfg.top_k + 1]
        margins.append(float((top[:, :-1] - top[:, 1:]).min()))
        return real(h, params, cfg)

    monkeypatch.setattr(ttf, "moe_ffn_stats", spy)
    return margins


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"), (True, "dots")])
def test_moe_transformer_matches_jax(tf_setup, monkeypatch, remat, policy):
    tree, tokens, ref = tf_setup
    _, tcfg = _tf_configs(remat, policy)
    model = convert.params_from_jax(tree, tcfg, device="cpu")
    assert model.blocks[0].router.shape == (64, 4)
    ttokens = torch.from_numpy(tokens).long()
    margins = _record_router_margins(monkeypatch)

    with torch.no_grad():
        logits, aux = model(ttokens, return_aux=True)
    # precondition: no layer's routing sits near a tie.  The router inputs
    # agree with JAX's to ~1e-6 here (f32 through at most one block, the
    # logits within TOL), so a margin of 1e-4 keeps every choice the same
    assert min(margins) > 1e-4, margins
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **TOL)
    np.testing.assert_allclose(float(aux), ref["aux"], **TOL)
    assert float(aux) > 0

    model.train()
    loss, grads = ttf.make_grad_step(tcfg)(model, ttokens)
    np.testing.assert_allclose(float(loss), ref["loss"], **TOL)
    got = convert.params_to_jax(grads, tcfg)
    assert np.abs(got["blocks"]["router"]).sum() > 0
    flat_got, tdef = jax.tree_util.tree_flatten(got)
    flat_want, jdef = jax.tree_util.tree_flatten(ref["grads"])
    assert tdef == jdef
    for a, b in zip(flat_got, flat_want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_moe_weights_round_trip(tf_setup):
    tree, _, _ = tf_setup
    _, tcfg = _tf_configs(False, "full")
    back = convert.params_to_jax(convert.params_from_jax(tree, tcfg, "cpu"), tcfg)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_moe_transformer_init_layout():
    _, tcfg = _tf_configs(False, "full")
    model = ttf.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    names = dict(model.named_parameters())
    assert names["blocks.1.w_gate"].shape == (4, 64, 128)
    assert names["blocks.1.w_down"].shape == (4, 128, 64)
    assert "blocks.0.w_gate.weight" not in names
    tokens = torch.randint(0, 256, (1, 64), generator=torch.Generator().manual_seed(2))
    loss = ttf.loss_fn(model, tokens)
    assert torch.isfinite(loss)
    stats = model.blocks[0].moe_stats
    assert 0.0 <= float(stats["dropped"]) <= 1.0 and float(stats["aux"]) > 0
