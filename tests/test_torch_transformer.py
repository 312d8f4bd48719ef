"""The port's transformer against the JAX package's, on the CPU.

A tiny f32 config; the JAX package's initial weights move into the port
through ``convert.params_from_jax``.  Logits, the loss and the gradients
(mapped back by ``convert.params_to_jax``) must match JAX ``forward`` and
``make_grad_step`` within ``atol=rtol=1e-4`` — the tolerance of
tests/test_flash_attention.py:135 for the flash model.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torchft_tpu.models import transformer as jtf
from torchft_tpu_torch import convert
from torchft_tpu_torch.models import transformer as ttf

TOL = dict(atol=1e-4, rtol=1e-4)
SHAPE = dict(
    vocab_size=512, d_model=128, n_heads=4, n_kv_heads=2, d_ff=384,
    n_layers=2, max_seq_len=128,
)


def _configs(attn_impl):
    return (
        jtf.TransformerConfig(dtype=jnp.float32, attn_impl=attn_impl, **SHAPE),
        ttf.TransformerConfig(dtype=torch.float32, attn_impl=attn_impl, **SHAPE),
    )


@pytest.fixture(scope="module")
def setup():
    jcfg, _ = _configs("dense")
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tokens = np.random.default_rng(1).integers(0, 512, (2, 128)).astype(np.int32)
    return params, tree, tokens


@pytest.mark.parametrize("attn_impl", ["flash", "dense"])
def test_logits_loss_and_grads_match_jax(setup, attn_impl):
    params, tree, tokens = setup
    jcfg, tcfg = _configs(attn_impl)
    model = convert.params_from_jax(tree, tcfg, device="cpu")
    ttokens = torch.from_numpy(tokens).long()

    with torch.no_grad():
        logits = model(ttokens)
    j_logits = jtf.forward(params, jnp.asarray(tokens), jcfg)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)

    loss, grads = ttf.make_grad_step(tcfg)(model, ttokens)
    j_loss, j_grads = jtf.make_grad_step(jcfg)(params, jnp.asarray(tokens))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), **TOL)
    got = jax.tree_util.tree_leaves(convert.params_to_jax(grads, tcfg))
    want = jax.tree_util.tree_leaves(j_grads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_weights_round_trip(setup):
    _, tree, _ = setup
    _, tcfg = _configs("dense")
    back = convert.params_to_jax(convert.params_from_jax(tree, tcfg, "cpu"), tcfg)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_init_matches_jax_statistics():
    # the port draws from a torch.Generator, so values differ from JAX's;
    # the distributions must not: N(0, 1/fan_in) projections, N(0, 0.02^2)
    # embedding, unit norms
    _, tcfg = _configs("dense")
    model = ttf.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert abs(model.embed.std().item() - 0.02) < 1e-3
    w = model.blocks[0].w_down.weight
    assert abs(w.std().item() * np.sqrt(w.shape[1]) - 1.0) < 0.02
    assert torch.equal(model.final_norm, torch.ones(128))
    again = ttf.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert torch.equal(model.embed, again.embed)


def test_remat_dots_raises_and_remat_full_matches():
    _, tcfg = _configs("dense")
    tokens = torch.randint(0, 512, (1, 128), generator=torch.Generator().manual_seed(2))
    model = ttf.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    loss_full, g_full = ttf.make_grad_step(tcfg)(model, tokens)
    plain = dataclasses.replace(tcfg, remat=False)
    model.cfg = plain
    loss_plain, g_plain = ttf.make_grad_step(plain)(model, tokens)
    assert torch.equal(loss_full, loss_plain)
    for name in g_full:
        torch.testing.assert_close(g_full[name], g_plain[name])
    # "dots" runs: it keeps the matmul outputs instead of recomputing them,
    # which changes no value
    dots = dataclasses.replace(tcfg, remat_policy="dots")
    model.cfg = dots
    loss_dots, g_dots = ttf.make_grad_step(dots)(model, tokens)
    assert torch.equal(loss_dots, loss_plain)
    for name in g_full:
        torch.testing.assert_close(g_dots[name], g_plain[name])
    model.cfg = dataclasses.replace(tcfg, remat_policy="nope")
    with pytest.raises(ValueError, match="remat_policy"):
        model(tokens)


class _CountOps(TorchDispatchMode):
    """Counts the matmuls and kernel-A ops dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                    torch.ops.torchft_tpu_torch.flash_fwd.default):
            self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("attn_impl", ["flash", "dense"])
def test_remat_dots_matches_jax_and_recomputes_no_matmul(setup, attn_impl):
    params, tree, tokens = setup
    jcfg, tcfg = _configs(attn_impl)
    jcfg = dataclasses.replace(jcfg, remat=True, remat_policy="dots")
    tcfg = dataclasses.replace(tcfg, remat=True, remat_policy="dots")
    model = convert.params_from_jax(tree, tcfg, device="cpu")
    ttokens = torch.from_numpy(tokens).long()
    j_loss, j_grads = jtf.make_grad_step(jcfg)(params, jnp.asarray(tokens))

    backward_ops = {}
    for name, cfg in (
        ("dots", tcfg),
        ("full", dataclasses.replace(tcfg, remat_policy="full")),
        ("none", dataclasses.replace(tcfg, remat=False)),
    ):
        model.cfg = cfg
        model.zero_grad(set_to_none=True)
        loss = ttf.loss_fn(model, ttokens)
        with _CountOps() as mode:
            loss.backward()
        backward_ops[name] = mode.counts
        if name == "dots":
            np.testing.assert_allclose(float(loss.detach()), float(j_loss), **TOL)
            grads = {n: p.grad for n, p in model.named_parameters()}
            got = jax.tree_util.tree_leaves(convert.params_to_jax(grads, tcfg))
            want = jax.tree_util.tree_leaves(j_grads)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, np.asarray(b), **TOL)
    # "dots" runs the backward's own matmuls only, as without remat;
    # "full" also recomputes the blocks' projections (and kernel A)
    assert backward_ops["dots"] == backward_ops["none"]
    mm = "aten.mm.default"
    assert backward_ops["full"][mm] >= backward_ops["dots"][mm] + 6 * tcfg.n_layers
    if attn_impl == "flash":
        fwd = "torchft_tpu_torch.flash_fwd.default"
        assert backward_ops["dots"][fwd] == 0
        assert backward_ops["full"][fwd] == tcfg.n_layers
