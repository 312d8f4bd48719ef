"""The port's Ulysses attention against the JAX package's, on the CPU.

Thread ranks with raw gloo groups (as tests/test_torch_ring_attention.py)
hold their sequence chunks; JAX runs its own ``ulysses_attention`` over a
virtual CPU mesh of the same size on the same numpy inputs (Pallas in
interpret mode where the global ``T % 128 == 0``).  Tolerances are
tests/test_ulysses.py's: ``atol=2e-6`` on the dense route, ``3e-6`` on the
flash route, and ``2e-6`` of the largest magnitude for the gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from torchft_tpu.ops import ulysses as jul
from torchft_tpu_torch.ops import flash_attention as fa
from torchft_tpu_torch.ops import ulysses as tul
from torchft_tpu_torch.parallel import multihost
from torchft_tpu_torch.parallel.axis import InnerMesh, MeshAxis

#: (cp, causal, t, h, hkv): MHA at cp 2 and 4; GQA that replicates K/V to
#: lcm(hkv, cp) heads (the flagship's 6 over 3 at cp 2, and 12 over 4 at
#: cp 3: lcm 12 = h); the flash route at a global T of 256
CASES = {
    "mha-2-causal": (2, True, 16, 4, 4),
    "mha-2-full": (2, False, 16, 4, 4),
    "mha-4-causal": (4, True, 16, 4, 4),
    "gqa-6over3-cp2": (2, True, 16, 6, 3),
    "gqa-12over4-cp3": (3, True, 12, 12, 4),
    "flash-2-causal": (2, True, 256, 4, 2),
}
TOL = {"flash-2-causal": 3e-6}
GRAD_CASES = ("gqa-6over3-cp2",)


def _inputs(case):
    cp, causal, t, h, hkv = CASES[case]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, t, h, 8)).astype(np.float32)
    k = rng.standard_normal((2, t, hkv, 8)).astype(np.float32)
    v = rng.standard_normal((2, t, hkv, 8)).astype(np.float32)
    w = np.arange(q.size, dtype=np.float32).reshape(q.shape) / q.size**2
    return q, k, v, w


@functools.lru_cache(maxsize=None)
def _jax(case):
    """JAX's ulysses_attention: the output, and for GRAD_CASES the
    gradients of sum(o * w)."""
    cp, causal = CASES[case][:2]
    q, k, v, w = _inputs(case)
    mesh = Mesh(np.array(jax.devices()[:cp]), ("cp",))

    def fn(q, k, v):
        return jul.ulysses_attention(q, k, v, mesh, axis_name="cp", causal=causal)

    if case not in GRAD_CASES:
        return np.asarray(fn(q, k, v)), None
    out, vjp = jax.vjp(fn, q, k, v)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(w))]


def run_cp(cp, body):
    """``body(rank, mesh)`` on ``cp`` thread ranks sharing a gloo cp axis."""
    worlds = multihost.local_worlds(cp, timeout=30.0)

    def rank(r):
        axis = MeshAxis("cp", worlds[r].new_group("cp", range(cp)), r, cp)
        return body(r, InnerMesh([axis], "cpu"))

    return multihost.run_ranks(rank, cp, timeout=60.0)


def _port(case):
    cp, causal = CASES[case][:2]
    q, k, v, w = _inputs(case)
    tl = q.shape[1] // cp
    grads = case in GRAD_CASES

    def body(r, mesh):
        sl = slice(r * tl, (r + 1) * tl)
        ins = [torch.from_numpy(x[:, sl]).requires_grad_(grads) for x in (q, k, v)]
        out = tul.ulysses_attention(*ins, mesh, axis_name="cp", causal=causal)
        if grads:
            (out * torch.from_numpy(w[:, sl])).sum().backward()
        return out.detach(), [x.grad for x in ins] if grads else None

    parts = run_cp(cp, body)
    out = torch.cat([p[0] for p in parts], dim=1).numpy()
    if not grads:
        return out, None
    return out, [torch.cat([p[1][i] for p in parts], dim=1).numpy() for i in range(3)]


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax(case):
    calls = fa.flash_fwd_plain.calls
    out, grads = _port(case)
    want, want_grads = _jax(case)
    np.testing.assert_allclose(out, want, atol=TOL.get(case, 2e-6))
    # the flash route runs kernel A's twin once per rank on the gathered
    # sequence; the dense route never
    assert fa.flash_fwd_plain.calls - calls == (2 if case.startswith("flash") else 0)
    if grads is not None:
        for name, a, b in zip("qkv", grads, want_grads):
            scale = float(np.abs(b).max())
            np.testing.assert_allclose(a / scale, b / scale, atol=2e-6,
                                       err_msg=f"d{name}")


def test_replicated_kv_heads_is_the_lcm():
    for h, hkv, size in ((8, 2, 4), (12, 4, 3), (6, 3, 2), (8, 4, 2)):
        assert tul._replicated_kv_heads(h, hkv, size) == \
            jul._replicated_kv_heads(h, hkv, size)


def test_raises_as_jax_does():
    def body(r, mesh):
        q3 = torch.zeros(1, 8, 3, 8)
        with pytest.raises(ValueError, match="divisible"):
            tul.ulysses_attention(q3, q3, q3, mesh)
        q4, k3 = torch.zeros(1, 8, 4, 8), torch.zeros(1, 8, 3, 8)
        with pytest.raises(ValueError, match="not a multiple"):
            tul.ulysses_attention(q4, k3, k3, mesh)
        return True

    assert run_cp(2, body) == [True, True]
