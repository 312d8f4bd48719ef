"""Fused 8-bit quantization on the card: hand-written CUDA kernels.

PyTorch port of ``torchft_tpu/ops/pallas_quant.py`` (kept under its JAX
name so a reader finds the counterpart; the kernels are CUDA now).  The
three Pallas kernels become three CUDA C++ kernels for Hopper (``csrc/``),
each behind a wrapper with a launch counter and beside a plain PyTorch twin
(with a call counter) that computes the same function:

=================  =====================  =======================
wrapper            kernel (csrc/)         replaces (Pallas)
=================  =====================  =======================
``quantize_int8``  ``quant_int8.cu``      ``_quantize_kernel`` (D)
``dequantize_int8`` ``dequant_int8.cu``   ``_dequantize_kernel`` (E)
``reduce_int8``    ``reduce_int8.cu``     ``_reduce_kernel`` (F)
=================  =====================  =======================

A wrapper runs its twin only for tensors on the CPU (the tests); for CUDA
tensors it launches the kernel or raises — there is no fallback.  The
public entry points keep the JAX package's signatures and return shapes:
:func:`fused_quantize_into_int8`, :func:`fused_dequantize_from_int8`,
:func:`fused_reduce_int8` and :func:`quantize_pytree`.

Shares the wire format of the host codec (``ops/quantization.py``): int8
payload + one f32 scale per row, ``scale = absmax/127`` (1.0 for an
all-zero row), ``q = clip(round_half_even(x / scale), ±127)``.  The
division is a division, not a product with a reciprocal, in the kernels
and in the twins.  The TPU's padding to (32, 128) tiles is a layout
artefact of that machine and is not carried over: zero padding changes no
absmax, so no result depends on it.
"""

from __future__ import annotations

import threading
from typing import Any, Tuple

import numpy as np
import torch

from torchft_tpu_torch import _kernels
from torchft_tpu_torch.utils.pytree import tree_map

INT8_MAX = 127.0

# replica groups and codec-pool threads launch concurrently; `+=` on a
# counter is a read-modify-write the interpreter lock does not make atomic
_count_lock = threading.Lock()


def _count(fn: Any, attr: str) -> None:
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + 1)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_cuda(name: str, *pairs: "Tuple[torch.Tensor, torch.dtype, tuple]") -> None:
    """The kernels' contract, checked before any pointer is passed: each
    tensor of the given dtype and shape, contiguous and on the first
    tensor's CUDA device."""
    dev = pairs[0][0].device
    for t, dtype, shape in pairs:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: takes CPU or CUDA tensors, got {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: got {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _scale_rows(absmax: torch.Tensor) -> torch.Tensor:
    # divide by a tensor, not a Python number: on CUDA, torch turns a
    # division by a host scalar into a product with its reciprocal, which
    # is not the IEEE quotient the kernels compute
    int8_max = torch.full_like(absmax, INT8_MAX)
    return torch.where(absmax > 0.0, absmax / int8_max, torch.ones_like(absmax))


def _requant(x: torch.Tensor) -> "Tuple[torch.Tensor, torch.Tensor]":
    """Kernel D's function on an f32 ``(rows, cols)`` tensor."""
    if x.shape[1] == 0:
        absmax = x.new_zeros((x.shape[0], 1))
    else:
        absmax = x.abs().amax(dim=1, keepdim=True)
    scale = _scale_rows(absmax)
    q = torch.clamp(torch.round(x / scale), -INT8_MAX, INT8_MAX)
    return scale.squeeze(1), q.to(torch.int8)


# ---------------------------------------------------------------------------
# plain twins (the CPU path, and the reference the card is held to)
# ---------------------------------------------------------------------------


def quantize_int8_plain(x: torch.Tensor) -> "Tuple[torch.Tensor, torch.Tensor]":
    """Kernel D's function: f32 ``(rows, cols)`` -> ``(scales f32 (rows,),
    payload int8 (rows, cols))``."""
    _count(quantize_int8_plain, "calls")
    return _requant(x)


quantize_int8_plain.calls = 0


def dequantize_int8_plain(scales: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """Kernel E's function: ``payload * scale[row]`` in f32."""
    _count(dequantize_int8_plain, "calls")
    return payload.to(torch.float32) * scales[:, None]


dequantize_int8_plain.calls = 0


def reduce_int8_plain(
    scales: torch.Tensor, payloads: torch.Tensor, inv: float
) -> "Tuple[torch.Tensor, torch.Tensor]":
    """Kernel F's function: dequantize the n shards, sum them in index
    order ``0..n-1`` in f32, multiply by ``inv``, requantize by D's rule.
    Each product and each sum is rounded on its own, as in the kernel."""
    _count(reduce_int8_plain, "calls")
    acc = payloads[0].to(torch.float32) * scales[0][:, None]
    for k in range(1, payloads.shape[0]):
        acc = acc + payloads[k].to(torch.float32) * scales[k][:, None]
    acc = acc * torch.tensor(inv, dtype=torch.float32)
    return _requant(acc)


reduce_int8_plain.calls = 0


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor) -> "Tuple[torch.Tensor, torch.Tensor]":
    """Kernel D: f32 ``(rows, cols)`` -> ``(scales (rows,), payload int8)``."""
    if x.dim() != 2:
        raise ValueError(f"quantize_int8: expected a 2-D tensor, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_int8_plain(x)
    rows, cols = x.shape
    _check_cuda("quantize_int8", (x, torch.float32, (rows, cols)))
    scales = torch.empty(rows, dtype=torch.float32, device=x.device)
    payload = torch.empty((rows, cols), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        rc = _kernels.entry("quant_int8")(
            x.data_ptr(), scales.data_ptr(), payload.data_ptr(), rows, cols,
            _stream(),
        )
    _kernels.check("quant_int8", rc)
    _count(quantize_int8, "launches")
    return scales, payload


quantize_int8.launches = 0


def dequantize_int8(scales: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """Kernel E: f32 ``(rows,)`` scales, int8 ``(rows, cols)`` -> f32."""
    if payload.dim() != 2:
        raise ValueError(
            f"dequantize_int8: expected a 2-D payload, got {tuple(payload.shape)}"
        )
    if payload.device.type == "cpu" and scales.device.type == "cpu":
        return dequantize_int8_plain(scales, payload)
    rows, cols = payload.shape
    _check_cuda(
        "dequantize_int8", (payload, torch.int8, (rows, cols)),
        (scales, torch.float32, (rows,)),
    )
    out = torch.empty((rows, cols), dtype=torch.float32, device=payload.device)
    with torch.cuda.device(payload.device):
        rc = _kernels.entry("dequant_int8")(
            scales.data_ptr(), payload.data_ptr(), out.data_ptr(), rows, cols,
            _stream(),
        )
    _kernels.check("dequant_int8", rc)
    _count(dequantize_int8, "launches")
    return out


dequantize_int8.launches = 0


def reduce_int8(
    scales: torch.Tensor, payloads: torch.Tensor, average_by: int = 0
) -> "Tuple[torch.Tensor, torch.Tensor]":
    """Kernel F: f32 ``(n, rows)`` scales, int8 ``(n, rows, cols)`` shards
    -> requantized ``(scales (rows,), payload int8 (rows, cols))``;
    ``average_by > 0`` multiplies the sum by ``1/average_by``."""
    if payloads.dim() != 3 or payloads.shape[0] < 1:
        raise ValueError(
            f"reduce_int8: expected (n >= 1, rows, cols) payloads, got "
            f"{tuple(payloads.shape)}"
        )
    inv = 1.0 / average_by if average_by > 0 else 1.0
    if payloads.device.type == "cpu" and scales.device.type == "cpu":
        return reduce_int8_plain(scales, payloads, inv)
    n, rows, cols = payloads.shape
    _check_cuda(
        "reduce_int8", (payloads, torch.int8, (n, rows, cols)),
        (scales, torch.float32, (n, rows)),
    )
    out_scales = torch.empty(rows, dtype=torch.float32, device=payloads.device)
    out_payload = torch.empty((rows, cols), dtype=torch.int8, device=payloads.device)
    with torch.cuda.device(payloads.device):
        rc = _kernels.entry("reduce_int8")(
            scales.data_ptr(), payloads.data_ptr(), out_scales.data_ptr(),
            out_payload.data_ptr(), n, rows, cols, inv, _stream(),
        )
    _kernels.check("reduce_int8", rc)
    _count(reduce_int8, "launches")
    return out_scales, out_payload


reduce_int8.launches = 0


# ---------------------------------------------------------------------------
# public entry points (the JAX package's signatures)
# ---------------------------------------------------------------------------


def _as_tensor(a: Any) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def _as_rows(a: torch.Tensor) -> torch.Tensor:
    """View as 2-D (rows, cols) — same convention as the host codec."""
    if a.dim() == 0:
        return a.reshape(1, 1)
    if a.dim() == 1:
        return a.reshape(1, -1)
    return a.reshape(a.shape[0], -1)


def fused_quantize_into_int8(a: Any) -> "Tuple[torch.Tensor, torch.Tensor]":
    """Per-row absmax int8 quantization on the tensor's device.

    Returns ``(scales f32 [rows], payload int8 [rows, cols])`` — the host
    codec's wire format, so a device-quantized buffer can be packed
    straight onto the wire.  The input is taken as f32, as in the JAX
    package.
    """
    x = _as_rows(_as_tensor(a)).to(torch.float32).contiguous()
    return quantize_int8(x)


def fused_dequantize_from_int8(
    scales: Any, payload: Any, shape: Any = None, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Inverse of :func:`fused_quantize_into_int8`; reshapes to ``shape``."""
    out = dequantize_int8(
        _as_tensor(scales).to(torch.float32).contiguous(),
        _as_tensor(payload).contiguous(),
    )
    if shape is not None:
        out = out.reshape(shape)
    return out.to(dtype)


def fused_reduce_int8(
    scales: Any, payloads: Any, average_by: int = 0
) -> "Tuple[torch.Tensor, torch.Tensor]":
    """Fused dequant-accumulate-requant over stacked per-rank shards.

    Args:
        scales: f32 ``(n, rows)`` per-rank row scales.
        payloads: int8 ``(n, rows, cols)`` per-rank payloads.
        average_by: if > 0, divide the accumulated sum (multiplied by
            ``1/average_by``, as the JAX kernel does).

    Returns requantized ``(scales [rows], payload [rows, cols])`` ready to
    go back on the wire.
    """
    return reduce_int8(
        _as_tensor(scales).to(torch.float32).contiguous(),
        _as_tensor(payloads).contiguous(),
        int(average_by),
    )


def quantize_pytree(tree: Any) -> Any:
    """Quantize every leaf of a pytree on its device: a tree of the same
    structure whose leaves are ``(scales, payload)`` tuples."""
    return tree_map(fused_quantize_into_int8, tree)


__all__ = [
    "dequantize_int8",
    "dequantize_int8_plain",
    "fused_dequantize_from_int8",
    "fused_quantize_into_int8",
    "fused_reduce_int8",
    "quantize_int8",
    "quantize_int8_plain",
    "quantize_pytree",
    "reduce_int8",
    "reduce_int8_plain",
]
