"""The port's flash attention against the JAX package's, on the CPU.

The same numpy inputs go through the JAX ``flash_attention`` (its Pallas
kernels in interpret mode, as tests/test_flash_attention.py runs them) and
through the port's wrappers, which take their plain PyTorch twins for CPU
tensors.  Tolerances are the JAX tests' own: forward ``atol=2e-5,
rtol=1e-5`` (test_flash_attention.py:32) and gradients ``atol=1e-5`` after
scaling by the largest magnitude (:112).  The CUDA kernels are held to the
twins on the card by chip_smoke.py and by the ``cuda``-marked test below.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax
from torchft_tpu.ops import flash_attention as jfa
from torchft_tpu.ops.ring_attention import dense_attention as j_dense
from torchft_tpu_torch.ops import flash_attention as tfa
from torchft_tpu_torch.ops.ring_attention import dense_attention as t_dense

FWD_TOL = dict(atol=2e-5, rtol=1e-5)


def _qkv(t, d, b=1, h=4, hkv=2, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal((b, t, n, d)).astype(np.float32)
        for n in (h, hkv, hkv)
    )


def _torch(*arrays):
    return tuple(torch.from_numpy(a.copy()) for a in arrays)


def _jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("t", [128, 256])
def test_forward_matches_jax(t, d, causal):
    q, k, v = _qkv(t, d, seed=t + d)
    jq, jk, jv = _jax(q, k, v)
    scale = 1.0 / np.sqrt(d)
    j_o, j_lse = jfa._fwd(
        jfa._to3(jq),
        jfa._to3(jnp.repeat(jk, 2, axis=2)),
        jfa._to3(jnp.repeat(jv, 2, axis=2)),
        scale,
        causal,
    )
    tq, tk, tv = _torch(q, k, v)
    tk, tv = tfa._expand_gqa(tk, tv, 4)
    o, lse = tfa.flash_fwd(tfa._to3(tq), tfa._to3(tk), tfa._to3(tv), scale, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(j_o), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), **FWD_TOL)
    # the [B, T, H, D] entry points against both JAX attentions
    out = tfa.flash_attention(*_torch(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jfa.flash_attention(jq, jk, jv, causal=causal)), **FWD_TOL
    )
    np.testing.assert_allclose(
        t_dense(*_torch(q, k, v), causal=causal).numpy(),
        np.asarray(j_dense(jq, jk, jv, causal=causal)),
        **FWD_TOL,
    )


@pytest.mark.parametrize(
    "t,d,causal", [(256, 64, True), (256, 64, False), (128, 32, True)]
)
def test_grads_match_jax(t, d, causal):
    q, k, v = _qkv(t, d, seed=7 * t + d)
    w = np.arange(q.size, dtype=np.float32).reshape(q.shape) / q.size

    def j_loss(q_, k_, v_):
        return (jfa.flash_attention(q_, k_, v_, causal=causal) * w).mean()

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(*_jax(q, k, v))
    tq, tk, tv = (x.requires_grad_() for x in _torch(q, k, v))
    (tfa.flash_attention(tq, tk, tv, causal=causal) * torch.from_numpy(w)).mean().backward()
    for name, a, b in zip("qkv", (tq.grad, tk.grad, tv.grad), j_grads):
        b = np.asarray(b)
        scale = float(np.abs(b).max()) + 1e-12
        np.testing.assert_allclose(
            a.numpy() / scale, b / scale, atol=1e-5, err_msg=f"d{name}"
        )


def test_offsets_match_jax_and_mask_whole_rows():
    # keys start inside the first tile (k_off=64): query rows 0..63 see no
    # key, so they must come out as exact zeros with lse ~ -inf
    q, k, v = _qkv(128, 32, h=2, hkv=2, seed=3)
    scale = 1.0 / np.sqrt(32)
    j_o, j_lse = jfa._fwd(
        *(jfa._to3(x) for x in _jax(q, k, v)), scale, True,
        jnp.array([0, 64], jnp.int32),
    )
    o, lse = tfa.flash_fwd(
        *(tfa._to3(x) for x in _torch(q, k, v)), scale, True, q_off=0, k_off=64
    )
    o, lse = o.numpy(), lse.numpy()
    np.testing.assert_array_equal(o[:, :64], 0.0)
    assert np.all(lse[:, :64] < -1e20)
    assert np.any(o[:, 64:] != 0.0)
    np.testing.assert_allclose(o, np.asarray(j_o), **FWD_TOL)
    np.testing.assert_allclose(lse[:, 64:], np.asarray(j_lse)[:, 64:], **FWD_TOL)
    # q precedes every k: the whole output is zero
    o_all, _ = tfa.flash_fwd(
        *(tfa._to3(x) for x in _torch(q, k, v)), scale, True, q_off=0, k_off=128
    )
    np.testing.assert_array_equal(o_all.numpy(), 0.0)


def test_rejects_unaligned_seq():
    q, k, v = _torch(*_qkv(100, 32))
    with pytest.raises(ValueError, match="128"):
        tfa.flash_attention(q, k, v)


def test_cpu_tensors_take_the_twin_not_the_kernel():
    q, k, v = _torch(*_qkv(128, 32))
    before = (tfa.flash_fwd.launches, tfa.flash_fwd_plain.calls)
    tfa.flash_attention(q, k, v)
    assert tfa.flash_fwd.launches == before[0]
    assert tfa.flash_fwd_plain.calls == before[1] + 1


@pytest.mark.cuda
def test_kernels_match_twins_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    g = torch.Generator(device="cuda").manual_seed(0)
    q3, k3, v3, do3 = (
        torch.randn(8, 256, 64, device="cuda", generator=g, dtype=torch.bfloat16)
        for _ in range(4)
    )
    scale = 0.125
    o, lse = tfa.flash_fwd(q3, k3, v3, scale, True)
    o_ref, lse_ref = tfa.flash_fwd_plain(q3, k3, v3, scale, True)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-3)
    delta = (do3.float() * o.float()).sum(-1)
    dk, dv = tfa.flash_bwd_kv(q3, k3, v3, do3, lse, delta, scale, True)
    dk_ref, dv_ref = tfa.flash_bwd_kv_plain(q3, k3, v3, do3, lse, delta, scale, True)
    dq = tfa.flash_bwd_q(q3, k3, v3, do3, lse, delta, scale, True)
    dq_ref = tfa.flash_bwd_q_plain(q3, k3, v3, do3, lse, delta, scale, True)
    for a, b in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        err = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert err < 2e-2
