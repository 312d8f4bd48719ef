"""Row-scaled 8-bit quantization for bandwidth-reduced DCN collectives.

PyTorch port of ``torchft_tpu/ops/quantization.py`` (reference:
torchft/quantization.py:44-686): per-row absmax scales, 8-bit payload, and
scales interleaved into one flat comm buffer; dequant-reduce-requant fuses
the reduction.  Both wire formats of the JAX package exist here:

- ``wire_dtype="int8"`` (default): uniform-grid int8 — the format the
  CUDA device-quantize kernel emits (``ops/pallas_quant.py``);
- ``wire_dtype="fp8_e4m3"``: ``float8_e4m3fn`` payloads, same 1 byte per
  element, non-uniform grid.  Host codec only (the native C fast path, or
  torch's ``float8_e4m3fn`` casts on the numpy fallback).  Numpy has no fp8
  type, so an fp8 payload is carried as its ``uint8`` bit patterns: the
  bytes on the wire are those of the JAX package's ``ml_dtypes`` payload.

``TORCHFT_QUANT_WIRE`` selects the collective layer's default.

Two implementations share the int8 wire format:
- host path (numpy + the native codec) used by the TCP/DCN collective layer;
- device path (``ops/pallas_quant.py``, a CUDA kernel) for quantizing on the
  card before the host copy.

Wire layout per array: ``[rows x f32 scale][rows x cols payload]``
flattened (payload dtype per ``wire_dtype``).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

INT8_MAX = 127.0
# float8_e4m3fn max finite value (the "fn" variant has no inf, max 448)
FP8_MAX = 448.0

WIRE_INT8 = "int8"
WIRE_FP8 = "fp8_e4m3"


def _wire(wire_dtype: str) -> "Tuple[np.dtype, float]":
    """(numpy payload dtype, absmax scale target) for a wire format."""
    if wire_dtype == WIRE_INT8:
        return np.dtype(np.int8), INT8_MAX
    if wire_dtype == WIRE_FP8:
        # the payload's bit patterns (see the module docstring)
        return np.dtype(np.uint8), FP8_MAX
    raise ValueError(
        f"unknown wire_dtype {wire_dtype!r}; expected "
        f"{WIRE_INT8!r} or {WIRE_FP8!r}"
    )


def resolve_wire(wire_dtype: "str | None") -> str:
    """Resolve a wire format: explicit value, else the
    ``TORCHFT_QUANT_WIRE`` env default, else int8 — validated either way.
    The one entry point every collective uses for the env knob."""
    if wire_dtype is None:
        from torchft_tpu_torch.utils.env import env_str

        wire_dtype = env_str("TORCHFT_QUANT_WIRE", WIRE_INT8)
    _wire(wire_dtype)
    return wire_dtype


# ---------------------------------------------------------------------------
# native fused codec (native/quant.cc via ctypes)
# ---------------------------------------------------------------------------
#
# The numpy codec below is the reference semantics; the native codec is
# the fast path for BOTH wire formats (~6-8x: row-blocked fused passes,
# no temporaries, GIL released during the call — int8 via fused
# absmax/round/narrow loops, fp8_e4m3 via a bit-twiddled RNE encoder and
# a 256-entry decode LUT built from torch's float8_e4m3fn).  Bit-identical
# output on finite inputs is asserted in the JAX package's
# tests/test_pallas_quant.py against ml_dtypes, and the port's wire bytes
# against the JAX package's in tests/test_torch_collectives.py.
# ``TORCHFT_NO_NATIVE_QUANT=1`` forces the numpy path.

_native_checked = False
_native_lib_handle = None

_F32P = ctypes.POINTER(ctypes.c_float)
_I8P = ctypes.POINTER(ctypes.c_int8)


def _native_lib():
    # env checked live (not cached) so tests can flip between paths
    from torchft_tpu_torch.utils.env import env_bool

    if env_bool("TORCHFT_NO_NATIVE_QUANT"):
        return None
    global _native_checked, _native_lib_handle
    if not _native_checked:
        _native_checked = True
        try:
            from torchft_tpu_torch._native import get_lib

            _native_lib_handle = get_lib()
        except Exception:  # noqa: BLE001 - numpy fallback is complete
            _native_lib_handle = None
    return _native_lib_handle


def _f32_ptr(a: np.ndarray, byte_off: int = 0):
    return ctypes.cast(a.ctypes.data + byte_off, _F32P)


def _i8_ptr(a: np.ndarray, byte_off: int = 0):
    return ctypes.cast(a.ctypes.data + byte_off, _I8P)


_U8P = ctypes.POINTER(ctypes.c_uint8)


def _u8_ptr(a: np.ndarray, byte_off: int = 0):
    return ctypes.cast(a.ctypes.data + byte_off, _U8P)


_fp8_lut: "Optional[np.ndarray]" = None


def _fp8_decode_lut() -> np.ndarray:
    """256-entry f32 decode table for float8_e4m3fn, built from torch's
    ``float8_e4m3fn`` so the native decode and the numpy fallback decode
    alike (NaN codes stay NaN)."""
    global _fp8_lut
    if _fp8_lut is None:
        _fp8_lut = (
            torch.arange(256, dtype=torch.int32).to(torch.uint8)
            .view(torch.float8_e4m3fn).float().numpy()
        )
    return _fp8_lut


def _fp8_encode(x: np.ndarray) -> np.ndarray:
    """f32 -> float8_e4m3fn bit patterns (uint8), round-to-nearest-even:
    the numpy fallback's encoder (the cast itself rounds, no rint pass)."""
    return (
        torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        .to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    )


def _widen(payload: np.ndarray) -> np.ndarray:
    """A payload the numpy multiply can take: int8 as it is, fp8 bit
    patterns decoded to f32 through the LUT."""
    if payload.dtype == np.int8:
        return payload
    return _fp8_decode_lut()[payload]


def _native_dequant_fma(
    lib, rows2: np.ndarray, scales: np.ndarray, acc: np.ndarray, overwrite: int
) -> bool:
    """Dispatch the wire format's native dequant-accumulate kernel into
    ``acc``; False when no kernel fits this payload dtype (fallback to
    numpy).  Preconditions (checked by callers): C-contiguous payload,
    f32 contiguous scales, f32 acc sized (rows, cols)."""
    if rows2.dtype == np.int8:
        lib.tft_dequant_fma(
            _i8_ptr(rows2), _f32_ptr(scales),
            rows2.shape[0], rows2.shape[1], _f32_ptr(acc), overwrite,
        )
        return True
    if rows2.dtype == np.uint8:  # float8_e4m3fn bit patterns
        lut = _fp8_decode_lut()
        lib.tft_dequant_fp8_fma(
            _u8_ptr(rows2), _f32_ptr(scales), _f32_ptr(lut),
            rows2.shape[0], rows2.shape[1], _f32_ptr(acc), overwrite,
        )
        return True
    return False


def _native_eligible(rows: np.ndarray, wire_dtype: str) -> bool:
    # Both wire formats have native kernels.  Bit-exactness vs numpy is
    # guaranteed for FINITE inputs; rows containing NaN take the same
    # degenerate branch on both paths (NaN-propagating absmax), but the
    # garbage PAYLOAD BYTES of such rows may differ (C element conversion
    # vs numpy astype-of-NaN) — row-level semantics, not byte identity.
    return (
        wire_dtype in (WIRE_INT8, WIRE_FP8)
        and _native_lib() is not None
        and rows.dtype == np.float32
        and rows.flags.c_contiguous
    )


def _as_rows(a: np.ndarray) -> np.ndarray:
    """View as 2-D (rows, cols): leading dim preserved, rest flattened."""
    if a.ndim == 0:
        return a.reshape(1, 1)
    if a.ndim == 1:
        return a.reshape(1, -1)
    return a.reshape(a.shape[0], -1)


def quantize(
    a: np.ndarray, wire_dtype: str = WIRE_INT8
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row absmax quantization -> (scales f32 [rows], payload 8-bit).

    Memory-bandwidth-bound on big arrays (the DCN host path quantizes
    ~GB-scale pseudograd fragments), so the hot loop is pass-minimal:
    multiply by the reciprocal scale (division is the slow ufunc), round
    in place, and skip the clip — absmax scaling bounds every product to
    [-max, max] by construction (1-ulp excursions round back to max).
    """
    dt, qmax = _wire(wire_dtype)
    rows = _as_rows(np.asarray(a, dtype=np.float32))
    if _native_eligible(rows, wire_dtype):
        scales = np.empty(rows.shape[0], dtype=np.float32)
        payload = np.empty(rows.shape, dtype=dt)
        if wire_dtype == WIRE_INT8:
            _native_lib().tft_quant_int8(
                _f32_ptr(rows), rows.shape[0], rows.shape[1],
                _f32_ptr(scales), _i8_ptr(payload),
            )
        else:
            _native_lib().tft_quant_fp8(
                _f32_ptr(rows), rows.shape[0], rows.shape[1],
                _f32_ptr(scales), _u8_ptr(payload),
            )
        return scales, payload
    absmax = np.abs(rows).max(axis=1)
    # Rows with absmax below qmax/f32max would overflow the reciprocal to
    # inf (inf*0 = NaN payload); values that tiny (< ~1e-36) carry no
    # quantizable signal, so such rows encode as exact zeros (scale 1.0),
    # same as all-zero rows.
    nonzero = absmax > qmax / np.finfo(np.float32).max
    scales = np.where(nonzero, absmax / qmax, 1.0).astype(np.float32)
    inv = np.divide(
        qmax, absmax, out=np.ones_like(absmax), where=nonzero
    ).astype(np.float32)
    tmp = rows * inv[:, None]
    if dt == np.int8:
        np.rint(tmp, out=tmp)
        return scales, tmp.astype(dt)
    return scales, _fp8_encode(tmp)


def quantize_packed(
    a: np.ndarray, wire_dtype: str = WIRE_INT8, pool=None
) -> np.ndarray:
    """Quantize straight into one packed wire buffer (header + scales +
    payload) — skips the ``pack`` concatenate pass.  Native fast path
    writes scales/payload into the buffer in place; fallback composes
    ``pack(*quantize(...))`` (same bytes either way).  ``pool``: optional
    BufferPool the wire buffer is drawn from (give it back after the
    send completes)."""
    rows = _as_rows(np.asarray(a, dtype=np.float32))
    if not _native_eligible(rows, wire_dtype):
        return pack(*quantize(rows, wire_dtype), wire_dtype)
    n_rows, cols = rows.shape
    nbytes = _HEADER_BYTES + n_rows * 4 + n_rows * cols
    buf = (
        pool.take(nbytes, np.uint8) if pool is not None
        else np.empty(nbytes, dtype=np.uint8)
    )
    buf[0] = _PACK_VERSION
    buf[1] = _WIRE_CODES[wire_dtype]
    buf[2] = buf[3] = 0
    # scales live at byte offset 4 — 4-byte aligned (numpy bases are
    # 16-aligned), which is all f32 stores need
    if wire_dtype == WIRE_INT8:
        _native_lib().tft_quant_int8(
            _f32_ptr(rows), n_rows, cols,
            _f32_ptr(buf, _HEADER_BYTES),
            _i8_ptr(buf, _HEADER_BYTES + n_rows * 4),
        )
    else:
        _native_lib().tft_quant_fp8(
            _f32_ptr(rows), n_rows, cols,
            _f32_ptr(buf, _HEADER_BYTES),
            _u8_ptr(buf, _HEADER_BYTES + n_rows * 4),
        )
    return buf


def dequantize(
    scales: np.ndarray,
    payload: np.ndarray,
    shape: "Tuple[int, ...]",
    dtype: np.dtype,
) -> np.ndarray:
    lib = _native_lib()
    if (
        lib is not None
        and dtype == np.float32
        and scales.dtype == np.float32
        and payload.flags.c_contiguous
        and scales.flags.c_contiguous
    ):
        rows2 = _as_rows(payload)
        out = np.empty(rows2.shape, dtype=np.float32)
        # guard above requires contiguous scales — pass it directly (an
        # ascontiguousarray temporary would be unreferenced by the time
        # ctypes extracts the address if the guard were ever relaxed)
        if _native_dequant_fma(lib, rows2, scales, out, 1):
            return out.reshape(shape)
    # one fused payload x f32 -> f32 pass; asarray avoids the astype copy
    # when dtype is already float32 (the common DCN case).  fp8 payloads
    # decode through the LUT first (one extra pass only on the fp8 leg).
    out = np.multiply(_widen(payload), scales[:, None], dtype=np.float32)
    return np.asarray(out.reshape(shape), dtype=dtype)


# Packed-buffer header: [version u8, wire-format code u8, reserved u16].
# The format code travels ON the wire so two ranks with divergent
# TORCHFT_QUANT_WIRE settings (partial rollout, heterogeneous launcher
# env) fail loudly at unpack instead of silently decoding each other's
# 1-byte payloads as the wrong grid.
_PACK_VERSION = 1
_WIRE_CODES = {WIRE_INT8: 0, WIRE_FP8: 1}
_WIRE_NAMES = {v: k for k, v in _WIRE_CODES.items()}
_HEADER_BYTES = 4


def pack(
    scales: np.ndarray, payload: np.ndarray, wire_dtype: str = WIRE_INT8
) -> np.ndarray:
    """Interleave header + scales + payload into one uint8 comm buffer
    (reference quantization.py:54-165 packs fp8 payload + f32 scales)."""
    header = np.array(
        [_PACK_VERSION, _WIRE_CODES[wire_dtype], 0, 0], dtype=np.uint8
    )
    return np.concatenate(
        [header, scales.view(np.uint8).ravel(), payload.view(np.uint8).ravel()]
    )


def unpack(
    buf: np.ndarray, rows: int, cols: int, wire_dtype: str = WIRE_INT8
) -> Tuple[np.ndarray, np.ndarray]:
    """Split a packed wire buffer back into (scales, payload), validating
    the on-wire format header against the locally expected ``wire_dtype``.

    Returns VIEWS into ``buf`` (zero-copy): every consumer immediately
    widens the payload in its own f32 pass, so a defensive copy here would
    only add a full memory pass at GB fragment scale."""
    dt, _ = _wire(wire_dtype)
    version, code = int(buf[0]), int(buf[1])
    if version != _PACK_VERSION:
        raise ValueError(
            f"quantized buffer version {version} != {_PACK_VERSION} "
            "(peer running an incompatible codec)"
        )
    if code != _WIRE_CODES[wire_dtype]:
        raise ValueError(
            f"wire format mismatch: peer sent "
            f"{_WIRE_NAMES.get(code, f'code {code}')}, local expects "
            f"{wire_dtype} (check TORCHFT_QUANT_WIRE on every rank)"
        )
    scale_end = _HEADER_BYTES + rows * 4
    scales = buf[_HEADER_BYTES:scale_end].view(np.float32)
    payload = buf[scale_end : scale_end + rows * cols].view(dt).reshape(
        rows, cols
    )
    return scales, payload


def dequantize_into(
    scales: np.ndarray, payload: np.ndarray, out: np.ndarray,
) -> None:
    """Dequantize into a caller-provided f32 ``(rows, cols)`` block — the
    allgather-reassembly path writes each rank's piece straight into its
    offset of the full output, skipping the per-piece alloc + concat."""
    rows2 = _as_rows(payload)
    assert out.dtype == np.float32 and out.flags.c_contiguous
    lib = _native_lib()
    if (
        lib is not None
        and scales.dtype == np.float32
        and rows2.flags.c_contiguous
    ):
        sc = np.ascontiguousarray(scales)
        if _native_dequant_fma(lib, rows2, sc, out, 1):
            return
    np.multiply(
        _widen(rows2), scales[:, None], dtype=np.float32,
        out=out.reshape(rows2.shape),
    )


# ---------------------------------------------------------------------------
# row-range codec surface (the chunked-pipeline / worker-pool entry points)
# ---------------------------------------------------------------------------
#
# Each helper operates on a row range [r0, r1) of a PACKED wire buffer
# (header + scales + payload, layout as ``pack``), against a full 2-D f32
# source/accumulator/output with its own row offset.  Rows are independent
# in every codec kernel (per-row absmax, per-row scale), so concurrent
# calls over DISJOINT ranges of one buffer are data-race-free — this is
# what ``ops/codec_pool.py`` fans across a small worker pool, with the
# native kernels releasing the GIL (native/quant.cc ``*_rows`` entry
# points).  The numpy fallbacks apply the exact per-row math of the
# monolithic codec above, so chunked output is bit-identical to monolithic
# on finite inputs for BOTH paths (asserted in
# tests/test_quantized_collectives.py).


def packed_nbytes(rows: int, cols: int) -> int:
    """Byte size of a packed wire buffer (8-bit payload wire formats)."""
    return _HEADER_BYTES + rows * 4 + rows * cols


def new_packed(
    rows: int, cols: int, wire_dtype: str = WIRE_INT8, pool=None
) -> np.ndarray:
    """Allocate (or pool-take) a packed wire buffer and write its header;
    scales/payload regions are left uninitialized for the row-range
    writers below."""
    _wire(wire_dtype)
    nbytes = packed_nbytes(rows, cols)
    buf = (
        pool.take(nbytes, np.uint8) if pool is not None
        else np.empty(nbytes, dtype=np.uint8)
    )
    buf[0] = _PACK_VERSION
    buf[1] = _WIRE_CODES[wire_dtype]
    buf[2] = buf[3] = 0
    return buf


def _packed_views(
    buf: np.ndarray, rows: int, cols: int, wire_dtype: str
) -> "Tuple[np.ndarray, np.ndarray]":
    """(scales f32 [rows], payload [rows, cols]) views into a packed buf
    (no header validation — internal writer-side helper)."""
    dt, _ = _wire(wire_dtype)
    scale_end = _HEADER_BYTES + rows * 4
    scales = buf[_HEADER_BYTES:scale_end].view(np.float32)
    payload = buf[scale_end : scale_end + rows * cols].view(dt).reshape(
        rows, cols
    )
    return scales, payload


def _rows_native(src: np.ndarray) -> bool:
    return (
        _native_lib() is not None
        and src.dtype == np.float32
        and src.flags.c_contiguous
    )


def quantize_rows_packed(
    src: np.ndarray,
    src_row0: int,
    buf: np.ndarray,
    rows: int,
    cols: int,
    r0: int,
    r1: int,
    wire_dtype: str = WIRE_INT8,
) -> None:
    """Quantize ``src[src_row0 : src_row0 + (r1-r0)]`` into packed ``buf``
    rows ``[r0, r1)``.  ``src`` is C-contiguous f32 ``(*, cols)``."""
    if r1 <= r0:
        return
    if _rows_native(src):
        lib = _native_lib()
        # pre-offset the source base so the kernel's single row index
        # covers both sides: row r reads src[src_row0 + (r - r0)]
        in_ptr = _f32_ptr(src, (src_row0 - r0) * cols * 4)
        sc_ptr = _f32_ptr(buf, _HEADER_BYTES)
        if wire_dtype == WIRE_INT8:
            lib.tft_quant_int8_rows(
                in_ptr, r0, r1, cols, sc_ptr,
                _i8_ptr(buf, _HEADER_BYTES + rows * 4),
            )
        else:
            lib.tft_quant_fp8_rows(
                in_ptr, r0, r1, cols, sc_ptr,
                _u8_ptr(buf, _HEADER_BYTES + rows * 4),
            )
        return
    scales, payload = quantize(
        src[src_row0 : src_row0 + (r1 - r0)].reshape(r1 - r0, cols),
        wire_dtype,
    )
    sc, pl = _packed_views(buf, rows, cols, wire_dtype)
    sc[r0:r1] = scales
    pl[r0:r1] = payload


def validate_packed(buf: np.ndarray, wire_dtype: str = WIRE_INT8) -> None:
    """Validate a packed buffer's on-wire header (version + format code)
    — the same loud cross-rank wire-format guard as :func:`unpack`,
    without building the views.  The pipeline calls this ONCE per
    received buffer before fanning row blocks; the row-range writers
    below stay validation-free on the hot path."""
    unpack(buf, 0, 0, wire_dtype)


def fma_rows_packed(
    buf: np.ndarray,
    rows: int,
    cols: int,
    r0: int,
    r1: int,
    wire_dtype: str,
    acc: np.ndarray,
    acc_row0: int,
    overwrite: bool,
) -> None:
    """``acc[acc_row0 : acc_row0 + (r1-r0)]`` (op)= dequant of packed
    ``buf`` rows ``[r0, r1)`` (op: overwrite or accumulate).  The caller
    validates the buffer header once via :func:`validate_packed`."""
    if r1 <= r0:
        return
    if _rows_native(acc):
        lib = _native_lib()
        acc_ptr = _f32_ptr(acc, (acc_row0 - r0) * cols * 4)
        sc_ptr = _f32_ptr(buf, _HEADER_BYTES)
        ow = 1 if overwrite else 0
        if wire_dtype == WIRE_INT8:
            lib.tft_dequant_fma_rows(
                _i8_ptr(buf, _HEADER_BYTES + rows * 4), sc_ptr,
                r0, r1, cols, acc_ptr, ow,
            )
        else:
            lut = _fp8_decode_lut()
            lib.tft_dequant_fp8_fma_rows(
                _u8_ptr(buf, _HEADER_BYTES + rows * 4), sc_ptr,
                _f32_ptr(lut), r0, r1, cols, acc_ptr, ow,
            )
        return
    sc, pl = _packed_views(buf, rows, cols, wire_dtype)
    pay = _widen(pl[r0:r1])
    target = acc[acc_row0 : acc_row0 + (r1 - r0)].reshape(r1 - r0, cols)
    if overwrite:
        np.multiply(pay, sc[r0:r1, None], dtype=np.float32, out=target)
    else:
        target += np.multiply(pay, sc[r0:r1, None], dtype=np.float32)


def div_rows(acc: np.ndarray, r0: int, r1: int, divisor: float) -> None:
    """In-place ``acc[r0:r1] /= divisor`` (the fused AVG step), native
    when available — bit-identical either way (true divide)."""
    if r1 <= r0 or not divisor:
        return
    if _rows_native(acc):
        _native_lib().tft_div_f32_rows(
            _f32_ptr(acc), r0, r1, acc.shape[-1] if acc.ndim > 1 else 1,
            float(divisor),
        )
        return
    acc[r0:r1] /= divisor


def dequant_rows_into(
    buf: np.ndarray,
    rows: int,
    cols: int,
    r0: int,
    r1: int,
    wire_dtype: str,
    out: np.ndarray,
    out_row0: int,
) -> None:
    """``out[out_row0 : out_row0 + (r1-r0)] = dequant(buf rows [r0,r1))``
    — the allgather-reassembly writer (overwrite form of
    :func:`fma_rows_packed`)."""
    fma_rows_packed(
        buf, rows, cols, r0, r1, wire_dtype, out, out_row0, overwrite=True
    )


def reduce_quantized(
    bufs: "List[np.ndarray]",
    rows: int,
    cols: int,
    average_by: int = 0,
    requantize: bool = True,
    wire_dtype: str = WIRE_INT8,
    raw: "Optional[np.ndarray]" = None,
    pool=None,
) -> np.ndarray:
    """Dequantize each packed buffer, accumulate in f32, requantize.

    Analog of the reference's fused dequant-accumulate-requant kernel
    (reference quantization.py:262-430). ``average_by > 0`` divides the
    accumulated sum (AVG fusion). ``requantize=False`` returns the raw f32
    accumulator (for results that stay local rather than going back on the
    wire).  ``raw`` is an optional f32 ``(rows, cols)`` contribution added
    WITHOUT passing through the codec — the quantized allreduce feeds a
    rank's own row-slice through here, so a rank pays neither codec time
    nor quantization error on its own data.  ``pool``: optional BufferPool
    for the accumulator and (when requantizing) the output wire buffer;
    the accumulator is returned to the pool before a requantized return.
    """
    lib = _native_lib() if wire_dtype in (WIRE_INT8, WIRE_FP8) else None

    def _fresh_acc() -> np.ndarray:
        if pool is not None:
            return pool.take((rows, cols), np.float32)
        return np.empty((rows, cols), dtype=np.float32)

    acc: "np.ndarray | None" = None
    if raw is not None:
        raw = np.ascontiguousarray(raw, dtype=np.float32).reshape(rows, cols)
        acc = _fresh_acc()
        np.copyto(acc, raw)
    for buf in bufs:
        scales, payload = unpack(buf, rows, cols, wire_dtype)
        if lib is not None and payload.flags.c_contiguous:
            first = acc is None
            if first:
                acc = _fresh_acc()
            # scales is an unaligned 4-byte-offset view into the wire
            # buffer — fine for f32 loads, but take a contiguous copy so
            # the pointer math below is plain
            sc = np.ascontiguousarray(scales)
            # unpack() derived the payload dtype from wire_dtype and lib
            # is gated on the same wire_dtype, so the dispatch always has
            # a kernel here (the bool return exists for dequantize's
            # caller-supplied payloads)
            dispatched = _native_dequant_fma(
                lib, payload, sc, acc, 1 if first else 0
            )
            assert dispatched, payload.dtype
            continue
        # numpy reference path: fused payload x f32 -> f32 product in one
        # pass; first buffer becomes the accumulator directly
        payload = _widen(payload)
        if acc is None:
            acc = _fresh_acc()
            np.multiply(payload, scales[:, None], dtype=np.float32, out=acc)
        else:
            acc += np.multiply(payload, scales[:, None], dtype=np.float32)
    if acc is None:
        acc = np.zeros((rows, cols), dtype=np.float32)
    if average_by > 0:
        if lib is not None and acc.flags.c_contiguous:
            lib.tft_div_f32(_f32_ptr(acc), acc.size, float(average_by))
        else:
            acc /= average_by
    if not requantize:
        return acc  # caller takes ownership (pooled or not)
    out = quantize_packed(acc, wire_dtype, pool=pool)
    if pool is not None:
        pool.give(acc)
    return out
