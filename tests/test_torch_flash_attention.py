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


@pytest.mark.parametrize("q_off,k_off", [(128, 0), (0, 192)])
def test_offset_twins_match_jax(q_off, k_off):
    """Kernels A's, B's and C's twins against the JAX ``_fwd``/``_bwd`` at
    the offsets the card checks too: queries after the keys (q_off=128),
    and keys starting inside a 128-row query block (k_off=192: rows
    0..191 see no key and come out exactly 0)."""
    q, k, v = _qkv(256, 32, h=2, hkv=2, seed=11 + q_off + k_off)
    do = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    scale = 1.0 / np.sqrt(32)
    offs = jnp.array([q_off, k_off], jnp.int32)
    jq3, jk3, jv3, jdo3 = (jfa._to3(x) for x in _jax(q, k, v, do))
    j_o, j_lse = jfa._fwd(jq3, jk3, jv3, scale, True, offs)
    j_grads = jfa._bwd(jq3, jk3, jv3, j_o, j_lse, jdo3, scale, True, offs)
    tq3, tk3, tv3, tdo3 = (tfa._to3(x) for x in _torch(q, k, v, do))
    o, lse = tfa.flash_fwd(tq3, tk3, tv3, scale, True, q_off, k_off)
    dead = max(0, k_off - q_off)
    np.testing.assert_array_equal(o.numpy()[:, :dead], 0.0)
    assert np.all(lse.numpy()[:, :dead] < -1e20)
    np.testing.assert_allclose(o.numpy(), np.asarray(j_o), **FWD_TOL)
    np.testing.assert_allclose(
        lse.numpy()[:, dead:], np.asarray(j_lse)[:, dead:], **FWD_TOL
    )
    delta = (tdo3 * o).sum(-1)
    args = (tq3, tk3, tv3, tdo3, lse, delta, scale, True, q_off, k_off)
    grads = (tfa.flash_bwd_q(*args), *tfa.flash_bwd_kv(*args))
    for name, a, b in zip(("dq", "dk", "dv"), grads, j_grads):
        b = np.asarray(b)
        top = float(np.abs(b).max()) + 1e-12
        np.testing.assert_allclose(a.numpy() / top, b / top, atol=1e-5, err_msg=name)


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


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 96, 128, 256])
def test_register_tile_kernels_match_twins_on_the_card(d):
    """Kernels A, B and C at each head-dim width they are instantiated at,
    and at d = 96, which runs the 128 one with zero-filled columns; causal,
    non-causal and at the offsets of a ring composition.  Rows that see no
    key are exactly 0, and a second launch gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    g = torch.Generator(device="cuda").manual_seed(d)
    q3, k3, v3, do3 = (
        torch.randn(4, 256, d, device="cuda", generator=g, dtype=torch.bfloat16)
        for _ in range(4)
    )
    scale = 1.0 / np.sqrt(d)
    cases = [(True, 0, 0), (False, 0, 0), (True, 128, 0), (True, 0, 64),
             (True, 0, 192), (True, 0, 256)]
    for causal, q_off, k_off in cases:
        case = f"d={d} causal={causal} q_off={q_off} k_off={k_off}"
        o, lse = tfa.flash_fwd(q3, k3, v3, scale, causal, q_off, k_off)
        o_ref, lse_ref = tfa.flash_fwd_plain(q3, k3, v3, scale, causal, q_off, k_off)
        torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2, rtol=2e-2, msg=case)
        torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0, msg=case)
        dead = min(max(0, k_off - q_off), 256) if causal else 0
        assert torch.count_nonzero(o[:, :dead]) == 0, case
        assert bool((lse[:, :dead] < -1e20).all()), case
        delta = (do3.float() * o.float()).sum(-1)
        args = (q3, k3, v3, do3, lse, delta, scale, causal, q_off, k_off)
        dk, dv = tfa.flash_bwd_kv(*args)
        dq = tfa.flash_bwd_q(*args)
        assert torch.count_nonzero(dq[:, :dead]) == 0, case
        if dead == 256:
            assert torch.count_nonzero(dk) == torch.count_nonzero(dv) == 0, case
        else:
            pairs = zip((dq, dk, dv),
                        (tfa.flash_bwd_q_plain(*args), *tfa.flash_bwd_kv_plain(*args)))
            for a, b in pairs:
                err = (a.float() - b.float()).abs().max() / b.float().abs().max()
                assert err < 2e-2, (case, float(err))
        o2, lse2 = tfa.flash_fwd(q3, k3, v3, scale, causal, q_off, k_off)
        dk2, dv2 = tfa.flash_bwd_kv(*args)
        dq2 = tfa.flash_bwd_q(*args)
        assert torch.equal(o, o2) and torch.equal(lse, lse2), case
        assert torch.equal(dk, dk2) and torch.equal(dv, dv2), case
        assert torch.equal(dq, dq2), case
