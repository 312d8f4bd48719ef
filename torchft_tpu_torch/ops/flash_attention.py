"""Flash attention: fused tiled causal attention on hand-written CUDA kernels.

PyTorch port of ``torchft_tpu/ops/flash_attention.py``.  The three Pallas
kernels become three CUDA C++ kernels for Hopper (``csrc/``), each behind a
wrapper with a launch counter and beside a plain PyTorch twin that computes
the same function:

====================  ==============================  ====================
wrapper               kernel (csrc/)                  replaces (Pallas)
====================  ==============================  ====================
``flash_fwd``         ``flash_fwd.cu``                ``_fwd_kernel``
``flash_bwd_kv``      ``flash_bwd_kv.cu``             ``_bwd_kv_kernel``
``flash_bwd_q``       ``flash_bwd_q.cu``              ``_bwd_q_kernel``
====================  ==============================  ====================

A wrapper runs its twin only for tensors on the CPU (the tests); for CUDA
tensors it launches the kernel or raises — there is no fallback.  The
kernels take bf16; an f32 CUDA tensor raises (the CPU twins take f32).

Semantics kept from the JAX package: ``[B, T, H, D]`` layout at
:func:`flash_attention`, GQA K/V broadcast up, ``scale = 1/sqrt(D)``,
``ValueError`` unless ``T % 128 == 0``, ``_NEG_INF = -1e30`` masking at
GLOBAL positions ``(q_off, k_off)`` (so a ring composition can reuse the
kernels), all-masked rows giving ``O = 0`` and ``lse ~ -inf``,
``l = max(l, 1e-30)``, and ``p``/``dS`` cast to the input type before their
products.  ``delta = rowsum(dO * O)`` is a plain torch op, as in JAX.  The
twins and the ring's merge take exp and log from
:mod:`~torchft_tpu_torch.ops.softmax_math` (``exp2``, as the kernels do).

:func:`ring_flash_local` composes the three kernels with context
parallelism, as the JAX package's function of that name does: kernel A on
each (local Q x visiting K/V) tile at global offsets, merged in f32, and B
and C per tile against the merged logsumexp.  Each wrapper also counts the
launches it made at a non-zero offset (``offset_launches``).
"""

from __future__ import annotations

import math
import threading
from typing import Any, Tuple

import torch

from torchft_tpu_torch import _kernels
from torchft_tpu_torch.ops import softmax_math
from torchft_tpu_torch.parallel import axis as axis_ops

_NEG_INF = -1e30
_ALIGN = 128
# replica groups launch from their own threads; `+=` on a counter is a
# read-modify-write the interpreter lock does not make atomic
_count_lock = threading.Lock()


def _count(fn: Any, attr: str) -> None:
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + 1)


def _check_len(t: int) -> None:
    if t % _ALIGN != 0:
        raise ValueError(f"flash attention requires seq len % 128 == 0, got {t}")


def _check_cuda(
    name: str, q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
    *more: torch.Tensor,
) -> None:
    """The kernels' contract, checked before any pointer is passed: bf16
    ``[BH, T, D]`` q/k/v (and dO like q), f32 ``[BH, Tq]`` statistics, all
    contiguous, 16-byte aligned and on one CUDA device; D a multiple of 16
    of at most 256."""
    bh, tq, d = q3.shape
    if k3.shape != v3.shape or k3.shape[0] != bh or k3.shape[2] != d:
        raise ValueError(f"{name}: q {tuple(q3.shape)}, k {tuple(k3.shape)}, "
                         f"v {tuple(v3.shape)} do not match")
    if d % 16 != 0 or d > 256:
        raise ValueError(f"{name}: head dim {d} must be a multiple of 16, <= 256")
    for t in (q3, k3, v3, *more):
        if t.device != q3.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q3.device}")
        if not t.is_contiguous() or t.data_ptr() % 16 != 0:
            raise ValueError(f"{name}: tensors must be contiguous and aligned")
    for t in (q3, k3, v3, *(m for m in more if m.dim() == 3)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got {t.dtype}")
    for t in more:
        want = (bh, tq, d) if t.dim() == 3 else (bh, tq)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: got {tuple(t.shape)}, expected {want}")
        if t.dim() == 2 and t.dtype != torch.float32:
            raise TypeError(f"{name}: lse and delta must be float32")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _causal_mask(
    tq: int, tk: int, q_off: int, k_off: int, device: torch.device
) -> torch.Tensor:
    rq = q_off + torch.arange(tq, device=device)
    rk = k_off + torch.arange(tk, device=device)
    return rq[:, None] >= rk[None, :]


# ---------------------------------------------------------------------------
# plain twins (the CPU path, and the reference the card is held to)
# ---------------------------------------------------------------------------


def flash_fwd_plain(
    q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, scale: float,
    causal: bool, q_off: int = 0, k_off: int = 0,
) -> "Tuple[torch.Tensor, torch.Tensor]":
    """Kernel A's function, over the whole row at once: ``(O, lse)``.
    Products take the input type's values and accumulate in f32."""
    _count(flash_fwd_plain, "calls")
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * scale
    if causal:
        mask = _causal_mask(q3.shape[1], k3.shape[1], q_off, k_off, q3.device)
        s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m > _NEG_INF / 2, softmax_math.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(q3.dtype).float(), v3.float())
    return (acc / l).to(q3.dtype), (m + softmax_math.log(l)).squeeze(-1)


flash_fwd_plain.calls = 0


def _recompute_p(q3, k3, lse, scale, causal, q_off, k_off) -> torch.Tensor:
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * scale
    p = softmax_math.exp(s - lse[..., None])
    if causal:
        mask = _causal_mask(q3.shape[1], k3.shape[1], q_off, k_off, q3.device)
        p = torch.where(mask, p, 0.0)
    return p


def flash_bwd_kv_plain(
    q3, k3, v3, do3, lse, delta, scale: float, causal: bool,
    q_off: int = 0, k_off: int = 0,
) -> "Tuple[torch.Tensor, torch.Tensor]":
    """Kernel B's function: ``(dK, dV)``."""
    _count(flash_bwd_kv_plain, "calls")
    dt = q3.dtype
    p = _recompute_p(q3, k3, lse, scale, causal, q_off, k_off)
    dv = torch.matmul(p.to(dt).float().transpose(1, 2), do3.float())
    dp = torch.matmul(do3.float(), v3.float().transpose(1, 2))
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.matmul(ds.to(dt).float().transpose(1, 2), q3.float())
    return dk.to(dt), dv.to(dt)


flash_bwd_kv_plain.calls = 0


def flash_bwd_q_plain(
    q3, k3, v3, do3, lse, delta, scale: float, causal: bool,
    q_off: int = 0, k_off: int = 0,
) -> torch.Tensor:
    """Kernel C's function: ``dQ``."""
    _count(flash_bwd_q_plain, "calls")
    dt = q3.dtype
    p = _recompute_p(q3, k3, lse, scale, causal, q_off, k_off)
    dp = torch.matmul(do3.float(), v3.float().transpose(1, 2))
    ds = p * (dp - delta[..., None]) * scale
    return torch.matmul(ds.to(dt).float(), k3.float()).to(dt)


flash_bwd_q_plain.calls = 0


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def flash_fwd(
    q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, scale: float,
    causal: bool, q_off: int = 0, k_off: int = 0,
) -> "Tuple[torch.Tensor, torch.Tensor]":
    """Kernel A: ``[BH, T, D]`` q, k, v -> ``(O [BH, T, D], lse [BH, T] f32)``."""
    _check_len(q3.shape[1])
    _check_len(k3.shape[1])
    if q3.device.type == "cpu":
        return flash_fwd_plain(q3, k3, v3, scale, causal, q_off, k_off)
    _check_cuda("flash_fwd", q3, k3, v3)
    bh, tq, d = q3.shape
    o = torch.empty_like(q3)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q3.device)
    with torch.cuda.device(q3.device):
        rc = _kernels.entry("flash_fwd")(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, tq, k3.shape[1], d, scale, int(causal),
            q_off, k_off, _stream(),
        )
    _kernels.check("flash_fwd", rc)
    _count(flash_fwd, "launches")
    if q_off or k_off:
        _count(flash_fwd, "offset_launches")
    return o, lse


flash_fwd.launches = 0
flash_fwd.offset_launches = 0  # of them, tiles at a non-zero offset


def flash_bwd_kv(
    q3, k3, v3, do3, lse, delta, scale: float, causal: bool,
    q_off: int = 0, k_off: int = 0,
) -> "Tuple[torch.Tensor, torch.Tensor]":
    """Kernel B: ``(dK, dV)`` given q, k, v, dO and the f32 lse, delta."""
    _check_len(q3.shape[1])
    _check_len(k3.shape[1])
    if q3.device.type == "cpu":
        return flash_bwd_kv_plain(
            q3, k3, v3, do3, lse, delta, scale, causal, q_off, k_off
        )
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    _check_cuda("flash_bwd_kv", q3, k3, v3, do3, lse, delta)
    bh, tq, d = q3.shape
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    with torch.cuda.device(q3.device):
        rc = _kernels.entry("flash_bwd_kv")(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, tq, k3.shape[1], d, scale, int(causal), q_off, k_off, _stream(),
        )
    _kernels.check("flash_bwd_kv", rc)
    _count(flash_bwd_kv, "launches")
    if q_off or k_off:
        _count(flash_bwd_kv, "offset_launches")
    return dk, dv


flash_bwd_kv.launches = 0
flash_bwd_kv.offset_launches = 0  # of them, tiles at a non-zero offset


def flash_bwd_q(
    q3, k3, v3, do3, lse, delta, scale: float, causal: bool,
    q_off: int = 0, k_off: int = 0,
) -> torch.Tensor:
    """Kernel C: ``dQ`` given q, k, v, dO and the f32 lse, delta."""
    _check_len(q3.shape[1])
    _check_len(k3.shape[1])
    if q3.device.type == "cpu":
        return flash_bwd_q_plain(
            q3, k3, v3, do3, lse, delta, scale, causal, q_off, k_off
        )
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    _check_cuda("flash_bwd_q", q3, k3, v3, do3, lse, delta)
    bh, tq, d = q3.shape
    dq = torch.empty_like(q3)
    with torch.cuda.device(q3.device):
        rc = _kernels.entry("flash_bwd_q")(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            bh, tq, k3.shape[1], d, scale, int(causal), q_off, k_off, _stream(),
        )
    _kernels.check("flash_bwd_q", rc)
    _count(flash_bwd_q, "launches")
    if q_off or k_off:
        _count(flash_bwd_q, "offset_launches")
    return dq


flash_bwd_q.launches = 0
flash_bwd_q.offset_launches = 0  # of them, tiles at a non-zero offset


# ---------------------------------------------------------------------------
# differentiable wrapper
# ---------------------------------------------------------------------------


@torch.library.custom_op(
    "torchft_tpu_torch::flash_fwd", mutates_args=(),
    schema="(Tensor q3, Tensor k3, Tensor v3, float scale, bool causal,"
    " int q_off=0, int k_off=0) -> (Tensor, Tensor)",
)
def flash_fwd_op(
    q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, scale: float,
    causal: bool, q_off: int = 0, k_off: int = 0,
) -> "Tuple[torch.Tensor, torch.Tensor]":
    """:func:`flash_fwd` as a dispatcher op, so that selective activation
    checkpointing (the transformer's ``remat_policy="dots"``) can name
    kernel A's outputs and keep them instead of launching it again in the
    backward (the ring's tiles at their offsets too)."""
    return flash_fwd(q3, k3, v3, scale, causal, q_off, k_off)


@flash_fwd_op.register_fake
def _(q3, k3, v3, scale, causal, q_off=0, k_off=0):
    return torch.empty_like(q3), q3.new_empty(q3.shape[:2], dtype=torch.float32)


class _Flash3(torch.autograd.Function):
    """``_flash3`` of the JAX package: forward is kernel A, backward is
    kernels B and C."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale: float, causal: bool):  # type: ignore[override]
        o, lse = flash_fwd_op(q3, k3, v3, scale, causal)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.scale = scale
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do3):  # type: ignore[override]
        q3, k3, v3, o, lse = ctx.saved_tensors
        do3 = do3.contiguous()
        # delta_i = rowsum(dO * O): tiny elementwise pass, plain torch
        delta = (do3.float() * o.float()).sum(dim=-1)
        dk, dv = flash_bwd_kv(q3, k3, v3, do3, lse, delta, ctx.scale, ctx.causal)
        dq = flash_bwd_q(q3, k3, v3, do3, lse, delta, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def _to3(x: torch.Tensor) -> torch.Tensor:
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d).contiguous()


def _from3(x3: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, t, d = x3.shape
    return x3.reshape(b, h, t, d).transpose(1, 2)


def _expand_gqa(
    k: torch.Tensor, v: torch.Tensor, h: int
) -> "Tuple[torch.Tensor, torch.Tensor]":
    rep = h // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return k, v


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Tiled fused causal attention, ``[B, T, H, D] -> [B, T, H, D]``.

    Drop-in for :func:`~torchft_tpu_torch.ops.ring_attention.dense_attention`
    with O(T) memory instead of the O(T^2) score matrix.  GQA K/V with
    fewer heads are broadcast up (the kernels are per head).  Requires
    ``T % 128 == 0``; other shapes should use ``dense_attention``.
    """
    b, t, h, d = q.shape
    if h % k.shape[2] != 0:
        raise ValueError(
            f"query heads {h} not a multiple of kv heads {k.shape[2]}"
        )
    k, v = _expand_gqa(k, v, h)
    scale = 1.0 / math.sqrt(d)
    out3 = _Flash3.apply(_to3(q), _to3(k), _to3(v), scale, causal)
    return _from3(out3, b, h)


# ---------------------------------------------------------------------------
# ring composition: flash tiles inside sequence-parallel ring attention
# ---------------------------------------------------------------------------


class _RingFlash(torch.autograd.Function):
    """``ring_flash_local`` of the JAX package: the forward runs kernel A on
    each (local Q x visiting K/V) tile at global offsets and merges the
    tiles' ``(O, lse)`` in f32; the backward runs B and C per tile against
    the merged lse, and the f32 dK/dV accumulators rotate with K/V.  The
    forward's tiles and shifts are dispatcher ops (``flash_fwd_op``,
    ``mesh_shift``), which ``remat_policy="dots"`` keeps: its recompute
    launches no tile and moves no byte."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal: bool):  # type: ignore[override]
        idx, size = axis.rank, axis.size
        b, tq, h, d = q.shape
        tk = k.shape[1]
        scale = 1.0 / math.sqrt(d)
        q3 = _to3(q)
        o3 = torch.zeros(q3.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(q3.shape[:2], _NEG_INF, dtype=torch.float32, device=q.device)
        kc, vc = k, v
        for s in range(size):
            kv_idx = (idx - s) % size
            ke, ve = _expand_gqa(kc, vc, h)
            o_s, lse_s = flash_fwd_op(
                q3, _to3(ke), _to3(ve), scale, causal, idx * tq, kv_idx * tk
            )
            # blockwise softmax combination over chunks (f32); a tile whose
            # rows see no key has lse ~ -1e30 and weighs exp(-huge) = 0
            m = torch.maximum(lse, lse_s)
            w1 = softmax_math.exp(lse - m)
            w2 = softmax_math.exp(lse_s - m)
            denom = torch.clamp_min(w1 + w2, 1e-30)
            o3 = o3 * (w1 / denom)[..., None] + o_s.float() * (w2 / denom)[..., None]
            lse = m + softmax_math.log(denom)
            if s < size - 1:  # the last shift would carry nothing back
                kc, vc = axis_ops.shift(axis, kc, vc)
        o = _from3(o3.to(q.dtype), b, h)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.axis, ctx.causal = axis, causal
        return o

    @staticmethod
    def backward(ctx, do):  # type: ignore[override]
        q, k, v, o, lse = ctx.saved_tensors
        axis, causal = ctx.axis, ctx.causal
        idx, size = axis.rank, axis.size
        b, tq, h, d = q.shape
        tk, hkv = k.shape[1], k.shape[2]
        rep = h // hkv
        scale = 1.0 / math.sqrt(d)
        q3, o3, do3 = _to3(q), _to3(o), _to3(do.to(q.dtype))
        # loop-invariant: rowsum(dO * O), computed once for all ring steps
        delta = (do3.float() * o3.float()).sum(dim=-1)
        dq3 = torch.zeros(q3.shape, dtype=torch.float32, device=q.device)
        dkc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kc, vc = k, v
        for s in range(size):
            kv_idx = (idx - s) % size
            ke, ve = _expand_gqa(kc, vc, h)
            k3, v3 = _to3(ke), _to3(ve)
            args = (q3, k3, v3, do3, lse, delta, scale, causal, idx * tq, kv_idx * tk)
            dk_s, dv_s = flash_bwd_kv(*args)
            dq3 += flash_bwd_q(*args).float()
            # fold expanded-head grads back onto the unexpanded K/V heads
            dkc = dkc + _from3(dk_s, b, h).reshape(b, tk, hkv, rep, d).sum(3).float()
            dvc = dvc + _from3(dv_s, b, h).reshape(b, tk, hkv, rep, d).sum(3).float()
            # K/V and their grad accumulators rotate together: after the
            # full cycle each accumulator is home again (K/V need no last hop)
            if s < size - 1:
                kc, vc, dkc, dvc = axis.shift((kc, vc, dkc, dvc))
            else:
                dkc, dvc = axis.shift((dkc, dvc))
        return (
            _from3(dq3, b, h).to(q.dtype), dkc.to(k.dtype), dvc.to(v.dtype),
            None, None,
        )


def ring_flash_local(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis: Any,
    causal: bool = True,
) -> torch.Tensor:
    """Per-rank ring attention with flash tiles: the K/V chunks rotate
    around the ``axis`` ring (a :class:`~torchft_tpu_torch.parallel.axis.
    MeshAxis`) and each (local Q x visiting K/V) tile runs kernel A at
    global offsets ``(rank * T_local, kv_rank * T_local)``; the backward
    runs B and C per tile against the merged logsumexp.

    q/k/v are this rank's chunks ``[B, T_local, H, D]``, rotary-embedded
    with global positions; GQA K/V rotate unexpanded.  Requires
    ``T_local % 128 == 0``; a CUDA tensor must be bf16 (the kernels' type),
    as for :func:`flash_attention`."""
    b, tq, h, d = q.shape
    if h % k.shape[2] != 0:
        raise ValueError(f"query heads {h} not a multiple of kv heads {k.shape[2]}")
    _check_len(tq)
    _check_len(k.shape[1])
    return _RingFlash.apply(q, k, v, axis, causal)


__all__ = [
    "flash_attention",
    "flash_bwd_kv",
    "flash_bwd_kv_plain",
    "flash_bwd_q",
    "flash_bwd_q_plain",
    "flash_fwd",
    "flash_fwd_plain",
    "ring_flash_local",
]
