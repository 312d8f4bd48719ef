"""The port's ring attention against the JAX package's, on the CPU.

Ranks are threads with raw gloo groups over one ``HashStore``
(``parallel/multihost.py``); each holds its sequence chunk and runs
``ring_attention`` over its inner mesh's ``cp`` axis.  JAX runs its own
``ring_attention`` over a virtual CPU mesh of the same size (Pallas in
interpret mode on the flash route), on the same numpy inputs.

Tolerances are tests/test_ring_attention.py's for the flash composition:
forward ``atol=2e-5, rtol=1e-5``; gradients ``2e-5`` after dividing by the
reference's largest magnitude.  The plain-body gradients are held, as that
file holds JAX's own, against the JAX package's ``dense_attention``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from torchft_tpu.ops import ring_attention as jra
from torchft_tpu_torch.ops import flash_attention as fa
from torchft_tpu_torch.ops import ring_attention as tra
from torchft_tpu_torch.ops import softmax_math
from torchft_tpu_torch.parallel import multihost
from torchft_tpu_torch.parallel.axis import InnerMesh, MeshAxis

FWD_TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = 2e-5


#: (route, cp, causal): the plain tile body at T_local = 8 or 4, the flash
#: route at T_local = 128; GQA K/V (4 query heads over 2) throughout
CASES = [
    ("plain", 2, True), ("plain", 2, False), ("plain", 4, True),
    ("plain", 4, False), ("flash", 2, True), ("flash", 2, False),
    ("flash", 4, True),
]


def _inputs(route, cp, seed=0):
    t, d = (16, 8) if route == "plain" else (128 * cp, 64)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, t, 4, d)).astype(np.float32)
    k = rng.standard_normal((2, t, 2, d)).astype(np.float32)
    v = rng.standard_normal((2, t, 2, d)).astype(np.float32)
    w = np.arange(q.size, dtype=np.float32).reshape(q.shape) / q.size
    return q, k, v, w


def _loss_weights(w):
    """d(mean(o * w))/do, the cotangent both sides differentiate."""
    return w / w.size


@functools.lru_cache(maxsize=None)
def _jax(route, cp, causal, grads):
    """JAX's ring_attention over a ("cp",) mesh of ``cp`` CPU devices:
    the output, and with ``grads`` the gradients of mean(o * w)."""
    q, k, v, w = _inputs(route, cp)
    mesh = Mesh(np.array(jax.devices()[:cp]), ("cp",))

    def fn(q, k, v):
        return jra.ring_attention(q, k, v, mesh, axis_name="cp", causal=causal)

    if not grads:
        return np.asarray(fn(q, k, v)), None
    out, vjp = jax.vjp(fn, q, k, v)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(_loss_weights(w)))]


def run_cp(cp, body):
    """``body(rank, mesh)`` on ``cp`` thread ranks sharing a gloo cp axis."""
    worlds = multihost.local_worlds(cp, timeout=30.0)

    def rank(r):
        axis = MeshAxis("cp", worlds[r].new_group("cp", range(cp)), r, cp)
        return body(r, InnerMesh([axis], "cpu"))

    return multihost.run_ranks(rank, cp, timeout=60.0)


def _port(route, cp, causal, grads=False):
    """The port's ring attention on ``cp`` thread ranks: the output
    chunks joined, and with ``grads`` the chunks' gradients of
    mean(o * w) joined."""
    q, k, v, w = _inputs(route, cp)
    tl = q.shape[1] // cp
    cot = torch.from_numpy(_loss_weights(w))

    def body(r, mesh):
        sl = slice(r * tl, (r + 1) * tl)
        ins = [torch.from_numpy(x[:, sl]).requires_grad_(grads) for x in (q, k, v)]
        out = tra.ring_attention(*ins, mesh, axis_name="cp", causal=causal)
        if grads:
            (out * cot[:, sl]).sum().backward()
        return out.detach(), [x.grad for x in ins] if grads else None

    parts = run_cp(cp, body)
    out = torch.cat([p[0] for p in parts], dim=1).numpy()
    if not grads:
        return out, None
    return out, [torch.cat([p[1][i] for p in parts], dim=1).numpy() for i in range(3)]


@pytest.mark.parametrize("route,cp,causal", CASES)
def test_forward_matches_jax(route, cp, causal):
    calls = fa.flash_fwd_plain.calls
    out, _ = _port(route, cp, causal)
    want, _ = _jax(route, cp, causal, (route, cp, causal) == ("flash", 2, True))
    np.testing.assert_allclose(out, want, **FWD_TOL)
    # the flash route runs kernel A's twin once per (rank, ring step) on
    # CPU tensors; the plain body never
    tiles = cp * cp if route == "flash" else 0
    assert fa.flash_fwd_plain.calls - calls == tiles


def _assert_grads_close(got, want):
    for name, a, b in zip("qkv", got, want):
        scale = float(np.abs(b).max()) + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=GRAD_TOL,
                                   err_msg=f"d{name}")


def test_flash_route_gradients_match_jax():
    """Kernels B and C's twins per tile against the merged lse, dK/dV
    accumulators rotating home: against JAX's ring_flash_local backward."""
    _, grads = _port("flash", 2, True, grads=True)
    _, want = _jax("flash", 2, True, True)
    _assert_grads_close(grads, want)


@pytest.mark.parametrize("cp", [2, 4])
def test_plain_body_gradients_match_jax_dense(cp):
    """Autograd through the plain body and the differentiable shifts."""
    q, k, v, w = _inputs("plain", cp)
    _, grads = _port("plain", cp, True, grads=True)
    want = jax.grad(
        lambda q, k, v: (jra.dense_attention(q, k, v, causal=True) * w).mean(),
        argnums=(0, 1, 2),
    )(q, k, v)
    _assert_grads_close(grads, [np.asarray(g) for g in want])


def test_ring_flash_local_takes_lane_aligned_chunks_only():
    q = torch.zeros(1, 64, 2, 8)

    def body(r, mesh):
        with pytest.raises(ValueError, match="% 128"):
            fa.ring_flash_local(q, q, q, mesh.axis("cp"))
        k3 = torch.zeros(1, 64, 3, 8)
        with pytest.raises(ValueError, match="not a multiple"):
            tra.ring_attention_local(q, k3, k3, mesh.axis("cp"))
        return True

    assert run_cp(2, body) == [True, True]


def test_sharded_attention_needs_the_axis():
    mesh = InnerMesh([MeshAxis("dp", None, 0, 1)], "cpu")
    q = torch.zeros(1, 16, 2, 8)
    with pytest.raises(ValueError, match="requires a 'cp' mesh axis"):
        tra.ring_attention(q, q, q, mesh)
    with pytest.raises(ValueError, match="requires a mesh"):
        tra.ring_attention(q, q, q, None)


def test_softmax_math_is_exp_and_log_within_its_stated_error():
    """The attention paths' exp and log (``ops/softmax_math.py``) against
    float64 at the bounds its docstring states, including the masked
    scores' -1e30 and an f32 log's rounding."""
    x = torch.linspace(-30.0, 0.0, 300_001)
    want = torch.exp(x.double())
    got = softmax_math.exp(x).double()
    assert float(((got - want).abs() / want)[x > -5].max()) <= 3e-7
    assert float((got - want).abs().max()) <= 6e-8
    assert float(softmax_math.exp(torch.tensor([-1e30, -1.44e30]))[0]) == 0.0
    y = torch.logspace(-30, 30, 300_001)
    err = (softmax_math.log(y).double() - torch.log(y.double())).abs()
    assert float((err / torch.log(y.double()).abs().clamp_min(1.0)).max()) <= 2 ** -23
