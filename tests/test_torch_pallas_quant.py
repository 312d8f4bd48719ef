"""Kernels D, E and F: the port's plain twins against the JAX functions.

The same numpy inputs, made from a seed, go through the JAX package's
``fused_*`` functions (Pallas in interpret mode on the CPU, as
tests/test_pallas_quant.py runs them) and through the port's entry points
on CPU tensors, where the wrappers take the twins.  On the card,
``chip_smoke.py`` holds each CUDA kernel to its twin bit for bit.

Where the JAX functions on the CPU are not IEEE arithmetic, the case is
pinned to its cause rather than hidden by a tolerance:

- XLA compiles the kernel's ``absmax / 127.0`` into ``absmax * f32(1/127)``
  (a division by a constant becomes a product with its rounded reciprocal),
  which lands one ulp off the IEEE quotient in some rows.  The port divides
  (the host codec's ``absmax / qmax``), so its scales equal the host wire
  format's bit for bit and the JAX kernel's up to that rewrite; payloads
  are equal bit for bit.
- XLA on the CPU flushes subnormals: a row of magnitude 1e-38 has an absmax
  of 0 there (scale 1, payload 0), where IEEE keeps it (scale 7.9e-41,
  payload +-127).
- In kernel F, XLA also fuses the dequantize into the sum: the JAX result
  is held to the JAX test's own tolerance, and the port's to the same
  arithmetic in numpy (IEEE, one rounding per operation) bit for bit.
"""

import numpy as np
import pytest
import torch

from torchft_tpu.ops import pallas_quant as jpq
from torchft_tpu.ops import quantization as jax_host_q
from torchft_tpu_torch.ops import pallas_quant as tpq

SHAPES = [(4, 16), (1, 1), (32, 128), (5, 130), (33, 7), (3, 4, 5), (17,)]
# absmax 127 makes the scale exactly 1, so x / scale keeps every .5 tie
TIES = np.array(
    [[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -127.0]], dtype=np.float32
)


def _rand(shape, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def _rows(x: np.ndarray) -> np.ndarray:
    if x.ndim == 0:
        return x.reshape(1, 1)
    return x.reshape(1, -1) if x.ndim == 1 else x.reshape(x.shape[0], -1)


def _ieee_quantize(x: np.ndarray):
    """Kernel D's rule in numpy: IEEE division, round half to even."""
    absmax = np.abs(x).max(axis=1)
    scales = np.where(absmax > 0, absmax / np.float32(127.0), 1.0).astype(np.float32)
    q = np.clip(np.rint(x / scales[:, None]), -127, 127).astype(np.int8)
    return scales, q


def _assert_scales_match_jax(port, jax_scales, x):
    """Port scales: the host codec's IEEE ``absmax / 127``; the JAX
    kernel's where they differ: XLA's ``absmax * f32(1/127)``."""
    absmax = np.abs(_rows(x)).max(axis=1)
    ieee = np.where(absmax > 0, absmax / np.float32(127.0), 1.0).astype(np.float32)
    np.testing.assert_array_equal(_bits(port), _bits(ieee))
    rewrite = np.where(
        absmax > 0, absmax * np.float32(1.0 / 127.0), 1.0
    ).astype(np.float32)
    np.testing.assert_array_equal(_bits(jax_scales), _bits(rewrite))


@pytest.mark.parametrize("shape", SHAPES + [(6, 8)])
def test_quantize_twin_matches_jax(shape):
    x = _rand(shape, seed=sum(shape))
    if shape == (6, 8):  # zero rows and exact .5 ties
        x[1] = 0.0
        x[4] = 0.0
        x[2] = TIES[0]
    js, jp = jpq.fused_quantize_into_int8(x)
    ts, tp = tpq.fused_quantize_into_int8(torch.from_numpy(x))
    assert ts.dtype == torch.float32 and tp.dtype == torch.int8
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    _assert_scales_match_jax(ts.numpy(), js, x)
    # and the host wire format's scales bit for bit
    hs, _ = jax_host_q.quantize(x)
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(hs))
    if shape == (6, 8):
        assert ts[1] == ts[4] == 1.0 and not tp[1].any() and not tp[4].any()
        assert tp[2].tolist() == [127, 0, 2, 2, 0, -2, 4, -127]


def test_quantize_subnormal_row_is_ieee_where_xla_flushes():
    x = np.array([[1e-38, -1e-38, 5e-39, 0.0]], dtype=np.float32)
    js, jp = jpq.fused_quantize_into_int8(x)
    ts, tp = tpq.fused_quantize_into_int8(torch.from_numpy(x))
    # XLA on the CPU: denormals flushed, the row reads as all zeros
    assert np.asarray(js).tolist() == [1.0]
    assert np.asarray(jp).tolist() == [[0, 0, 0, 0]]
    # the port (and nvcc's default, no flush): IEEE
    assert _bits(ts.numpy()).tolist() == _bits(np.float32(1e-38) / np.float32(127)).reshape(1).tolist()
    assert tp.tolist() == [[127, -127, 63, 0]]


@pytest.mark.parametrize("shape", [(4, 16), (5, 130), (33, 7), (6, 8)])
def test_dequantize_twin_matches_jax(shape):
    x = _rand(shape, seed=100 + sum(shape))
    x[0] = 0.0
    scales, payload = jax_host_q.quantize(x)
    want = np.asarray(jpq.fused_dequantize_from_int8(scales, payload, shape=x.shape))
    got = tpq.fused_dequantize_from_int8(
        torch.from_numpy(scales), torch.from_numpy(payload), shape=x.shape
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


# widths that split kernel F's branches on the card: 2048 codes, the
# widest row it sums in registers in one pass; 16k + 7, an unaligned row;
# 2064, one 16-code chunk past the register budget (both two-pass)
REDUCE_COLS = [2048, 16 * 2 + 7, 2064]


@pytest.mark.parametrize("average_by", [0, 3])
@pytest.mark.parametrize("cols", REDUCE_COLS)
@pytest.mark.parametrize("n", [1, 2, 3])
def test_reduce_twin_matches_jax(n, cols, average_by):
    rows = 9
    shards = [_rand((rows, cols), seed=200 + 10 * n + i + cols) for i in range(n)]
    for s in shards:
        s[3] = 0.0  # a row that sums to zero
    quantized = [jax_host_q.quantize(s) for s in shards]
    scales = np.stack([q[0] for q in quantized])
    payloads = np.stack([q[1] for q in quantized])
    js, jp = jpq.fused_reduce_int8(scales, payloads, average_by)
    ts, tp = tpq.fused_reduce_int8(
        torch.from_numpy(scales), torch.from_numpy(payloads), average_by
    )
    # against the JAX kernel: the JAX test's own tolerance
    # (tests/test_pallas_quant.py: scales rtol 1e-5, at most one code).
    # XLA fuses the dequantize into the sum and rewrites the requantize's
    # absmax / 127, so its scales are not the IEEE ones bit for bit.
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    codes = np.abs(tp.numpy().astype(np.int32) - np.asarray(jp).astype(np.int32))
    assert codes.max() <= 1
    # against IEEE arithmetic in numpy, the kernel's stated semantics:
    # products and sums rounded one at a time, shards in index order
    inv = np.float32(1.0 / average_by if average_by > 0 else 1.0)
    acc = payloads[0].astype(np.float32) * scales[0][:, None]
    for k in range(1, n):
        acc = acc + payloads[k].astype(np.float32) * scales[k][:, None]
    want_s, want_p = _ieee_quantize(acc * inv)
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(want_s))
    np.testing.assert_array_equal(tp.numpy(), want_p)
    assert ts[3] == 1.0 and not tp[3].any()


def test_quantize_pytree_and_counters():
    tree = {"a": _rand((4, 8), 1), "b": [_rand((2, 3), 2)]}
    calls = tpq.quantize_int8_plain.calls
    out = tpq.quantize_pytree(
        {"a": torch.from_numpy(tree["a"]), "b": [torch.from_numpy(tree["b"][0])]}
    )
    s, p = out["a"]
    js, jp = jpq.quantize_pytree(tree)["a"]
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    assert isinstance(out["b"], list) and len(out["b"][0]) == 2
    # on CPU tensors only the twins run, never a kernel
    assert tpq.quantize_int8_plain.calls - calls == 2


def test_non_cpu_tensor_raises_and_never_takes_the_twin():
    calls = (
        tpq.quantize_int8_plain.calls, tpq.dequantize_int8_plain.calls,
        tpq.reduce_int8_plain.calls,
    )
    # a tensor that is not on the CPU goes to the kernel path, which checks
    # the device before anything else (a CUDA tensor cannot be made here)
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tpq.quantize_int8(x)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tpq.dequantize_int8(
            torch.empty(4, device="meta"),
            torch.empty((4, 8), dtype=torch.int8, device="meta"),
        )
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tpq.reduce_int8(
            torch.empty((2, 4), device="meta"),
            torch.empty((2, 4, 8), dtype=torch.int8, device="meta"),
        )
    with pytest.raises((RuntimeError, AssertionError)):
        tpq.quantize_int8(torch.empty((4, 8), device="cuda"))
    assert calls == (
        tpq.quantize_int8_plain.calls, tpq.dequantize_int8_plain.calls,
        tpq.reduce_int8_plain.calls,
    )


@pytest.mark.cuda
def test_kernels_match_twins_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    g = torch.Generator(device="cuda").manual_seed(0)
    for rows, cols in ((64, 2048), (33, 7), (5, 130), (3, 2051)):
        x = torch.randn(rows, cols, device="cuda", generator=g)
        x[0] = 0.0
        s, p = tpq.quantize_int8(x)
        s0, p0 = tpq.quantize_int8_plain(x)
        assert torch.equal(s.view(torch.int32), s0.view(torch.int32))
        assert torch.equal(p, p0)
        out, out0 = tpq.dequantize_int8(s, p), tpq.dequantize_int8_plain(s, p)
        assert torch.equal(out.view(torch.int32), out0.view(torch.int32))
        S, P = torch.stack([s, s.flip(0)]), torch.stack([p, p.flip(0)])
        for avg, inv in ((0, 1.0), (2, 0.5)):
            rs, rp = tpq.reduce_int8(S, P, avg)
            ts, tp = tpq.reduce_int8_plain(S, P, inv)
            assert torch.equal(rs.view(torch.int32), ts.view(torch.int32))
            assert torch.equal(rp, tp)
    # kernel F at every shard count and at the widths that split its
    # branches (one pass in registers; unaligned; past the register budget)
    for n in (1, 2, 3):
        for cols in REDUCE_COLS:
            xs = torch.randn(n, 37, cols, device="cuda", generator=g)
            xs[:, 3] = 0.0
            qs = [tpq.quantize_int8(x) for x in xs]
            S = torch.stack([q[0] for q in qs])
            P = torch.stack([q[1] for q in qs])
            for avg in (0, 3):
                rs, rp = tpq.reduce_int8(S, P, avg)
                ts, tp = tpq.reduce_int8_plain(S, P, 1.0 / avg if avg else 1.0)
                case = f"n={n} cols={cols} average_by={avg}"
                assert torch.equal(rs.view(torch.int32), ts.view(torch.int32)), case
                assert torch.equal(rp, tp), case
                assert rs[3] == 1.0 and not rp[3].any(), case
    with pytest.raises(TypeError):
        tpq.quantize_int8(torch.zeros(4, 8, device="cuda", dtype=torch.float16))
