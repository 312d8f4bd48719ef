"""The port's transformer under context parallelism against the JAX
package's, on the CPU.

A tiny f32 2-layer config; the JAX package's initial weights move into each
rank's model through ``convert.params_from_jax``.  Thread ranks with raw
gloo groups form the inner mesh (``ft_init_device_mesh`` over
``local_worlds``); each takes the whole ``[B, T]`` token array, runs its
chunk and returns the global loss and the gradients summed over the mesh.
JAX runs ``forward`` and ``make_grad_step`` over a ``("cp",)`` mesh of the
same size.  Tolerance ``atol=5e-5, rtol=1e-4``, tests/test_ulysses.py's
for the transformer.  The targets of each chunk's last position are the
next chunk's first token, so the loss and the gradients cover the chunk
boundary.
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
from torchft_tpu_torch.models import transformer as ttf
from torchft_tpu_torch.parallel import multihost
from torchft_tpu_torch.parallel.axis import InnerMesh, MeshAxis
from torchft_tpu_torch.parallel.device_mesh import ft_init_device_mesh

TOL = dict(atol=5e-5, rtol=1e-4)
SHAPE = dict(
    vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    n_layers=2, max_seq_len=256,
)
#: attention route -> (attn_impl, T): ring on flash tiles (T_local = 128),
#: ring's plain tile body (T_local = 32), Ulysses (dense on the gathered T)
ROUTES = {"ring-flash": ("ring", 256), "ring-plain": ("ring", 64), "ulysses": ("ulysses", 64)}


def _configs(attn_impl, **kw):
    return (
        jtf.TransformerConfig(dtype=jnp.float32, attn_impl=attn_impl, remat=False,
                              **SHAPE, **kw),
        ttf.TransformerConfig(dtype=torch.float32, attn_impl=attn_impl, remat=False,
                              **SHAPE, **kw),
    )


@functools.lru_cache(maxsize=None)
def _setup(t):
    jcfg, _ = _configs("dense")
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tokens = np.random.default_rng(1).integers(0, 256, (2, t)).astype(np.int32)
    return params, tree, tokens


def run_mesh(shape, body):
    """``body(rank, mesh)`` on thread ranks forming the inner mesh
    ``shape`` (e.g. ``{"cp": 2}``)."""
    n = int(np.prod(list(shape.values())))
    worlds = multihost.local_worlds(n, timeout=30.0)

    def rank(r):
        mesh = ft_init_device_mesh(None, shape, groups=worlds[r], device="cpu").mesh
        return body(r, mesh)

    return multihost.run_ranks(rank, n, timeout=60.0)


def _port_step(tcfg, tree, tokens, shape):
    """Each rank's chunk logits, loss and gradients (JAX layout)."""
    def body(r, mesh):
        model = convert.params_from_jax(tree, tcfg, device="cpu")
        ttokens = torch.from_numpy(tokens).long()
        tl = tokens.shape[1] // mesh.axis_size("cp")
        start = mesh.axis_index("cp") * tl
        with torch.no_grad():
            logits = model(ttokens[:, start:start + tl], mesh=mesh)
        loss, grads = ttf.make_grad_step(tcfg, mesh)(model, ttokens)
        return logits, float(loss), grads

    return run_mesh(shape, body)


@pytest.mark.parametrize("route", list(ROUTES))
def test_cp2_logits_loss_and_grads_match_jax(route):
    impl, t = ROUTES[route]
    params, tree, tokens = _setup(t)
    jcfg, tcfg = _configs(impl)
    mesh = Mesh(np.array(jax.devices()[:2]), ("cp",))
    j_logits = jtf.forward(params, jnp.asarray(tokens), jcfg, mesh=mesh)
    j_loss, j_grads = jtf.make_grad_step(jcfg, mesh)(params, jnp.asarray(tokens))

    ranks = _port_step(tcfg, tree, tokens, {"cp": 2})
    logits = torch.cat([r[0] for r in ranks], dim=1)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    for _, loss, grads in ranks:
        np.testing.assert_allclose(loss, float(j_loss), **TOL)
        got = jax.tree_util.tree_leaves(convert.params_to_jax(grads, tcfg))
        want = jax.tree_util.tree_leaves(j_grads)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
    # the inner sum gives every rank the same bits
    for name, g in ranks[0][2].items():
        assert torch.equal(g, ranks[1][2][name]), name


def test_dp2_cp2_matches_jax_without_a_mesh():
    """Four ranks, batch rows over dp and sequence chunks over cp: the
    summed shares are JAX's single-device loss and gradients."""
    params, tree, tokens = _setup(64)
    jcfg, tcfg = _configs("ring")
    j_loss, j_grads = jtf.make_grad_step(dataclasses.replace(jcfg, attn_impl="dense"))(
        params, jnp.asarray(tokens))
    ranks = _port_step(tcfg, tree, tokens, {"dp": 2, "cp": 2})
    want = jax.tree_util.tree_leaves(j_grads)
    for _, loss, grads in ranks:
        np.testing.assert_allclose(loss, float(j_loss), **TOL)
        got = jax.tree_util.tree_leaves(convert.params_to_jax(grads, tcfg))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_full_remat_under_cp_repeats_the_ring_and_changes_nothing():
    """The recompute repeats each block's ring exchanges, in the same
    order on every rank; the values are those without remat."""
    _, tree, tokens = _setup(64)
    _, tcfg = _configs("ring")
    plain = _port_step(tcfg, tree, tokens, {"cp": 2})
    remat = _port_step(dataclasses.replace(tcfg, remat=True, remat_policy="full"),
                       tree, tokens, {"cp": 2})
    for a, b in zip(plain, remat):
        assert a[1] == b[1]
        for name in a[2]:
            torch.testing.assert_close(b[2][name], a[2][name], rtol=0, atol=0)


def test_auto_resolves_to_ring_on_a_cp_mesh():
    _, tcfg = _configs("auto")
    mesh = InnerMesh([MeshAxis("cp", _FakeGroup(), 0, 2)], "cpu")
    assert ttf._resolve_attn_impl(tcfg, 64, torch.device("cpu"), mesh) == "ring"
    assert ttf._resolve_attn_impl(tcfg, 64, torch.device("cpu"), None) == "dense"


class _FakeGroup:
    def name(self):
        return "gloo"


def test_what_is_not_ported_under_a_mesh_raises():
    """Everything the JAX package composes runs under an inner mesh now
    (pp, ep, MoE, remat "dots" under cp); what is refused is what cannot
    run: attention that needs the whole sequence on a cp mesh, ring
    attention without a mesh, experts or layers that do not split, and a
    model whose weights are not sharded for its mesh."""
    cp2 = InnerMesh([MeshAxis("cp", _FakeGroup(), 0, 2)], "cpu")
    tokens = torch.zeros(1, 64, dtype=torch.long)
    for kw, err in (
        (dict(attn_impl="flash"), ValueError),
        (dict(attn_impl="dense"), ValueError),
    ):
        _, tcfg = _configs("ring")
        tcfg = dataclasses.replace(tcfg, **kw)
        model = ttf.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
        with pytest.raises(err):
            ttf.loss_fn(model, tokens, cp2)
    _, tcfg = _configs("ring")
    model = ttf.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        model(tokens)
    # 3 experts over ep = 2, 2 layers over pp = 4
    ep2 = InnerMesh([MeshAxis("ep", _FakeGroup(), 0, 2)], "cpu")
    moe = ttf.init_params(torch.Generator().manual_seed(0),
                          dataclasses.replace(tcfg, n_experts=3), "cpu")
    with pytest.raises(ValueError, match="experts do not split"):
        ttf.loss_fn(moe, tokens, ep2)
    pp4 = InnerMesh([MeshAxis("pp", _FakeGroup(), 0, 4)], "cpu")
    with pytest.raises(ValueError, match="not divisible by pp"):
        ttf.loss_fn(model, tokens, pp4)
    # weights sharded over fsdp, layers over pp: an unsharded model is
    # refused with a pointer to shard_params
    for axis in ("fsdp", "pp"):
        mesh = InnerMesh([MeshAxis(axis, _FakeGroup(), 0, 2)], "cpu")
        with pytest.raises(ValueError, match="shard_params"):
            ttf.loss_fn(model, tokens, mesh)
