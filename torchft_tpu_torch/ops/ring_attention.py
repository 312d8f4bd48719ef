"""Ring attention: context-parallel causal attention over a mesh axis.

PyTorch port of ``torchft_tpu/ops/ring_attention.py``.  The sequence is
split over the inner mesh's ``cp`` axis; K/V chunks rotate around the ring
(:meth:`~torchft_tpu_torch.parallel.axis.MeshAxis.shift`, the port's
``ppermute``) and each rank merges its output with a running online
softmax, so nothing materializes the full ``[T, T]`` score matrix.

Lane-aligned chunks (``T_local % 128 == 0``, the JAX package's own
selection) take :func:`~torchft_tpu_torch.ops.flash_attention.
ring_flash_local`: kernels A, B and C per tile at global offsets.  Other
chunk lengths take the plain online-softmax tile body, which the JAX
package computes outside any Pallas kernel, so plain torch ops are its
port.

Kept divergence: JAX's :func:`sharded_attention` and :func:`ring_attention`
take global arrays and ``shard_map`` them; an SPMD torch program has no
global arrays, so here they take this rank's local chunks and the inner
mesh.  :func:`dense_attention` is the single-device path.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable

import torch

from torchft_tpu_torch.ops import softmax_math
from torchft_tpu_torch.parallel import axis as axis_ops

_NEG_INF = -1e30
_warned_dense: set = set()


def dense_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Plain (single-pass) causal attention over the full sequence,
    ``[B, T, H, D]``.  GQA: K/V with fewer heads are broadcast up to the
    query head count.

    Materializes the full ``[B, H, T, T]`` score matrix — O(T^2) memory.
    Products take the input type's values and accumulate in f32 (the JAX
    package's ``preferred_element_type=float32``); softmax statistics are
    f32; the output has the input type."""
    d = q.shape[-1]
    t_full = q.shape[1]
    if t_full > 4096:
        key = (q.shape[0], q.shape[2], t_full)
        if key not in _warned_dense:
            _warned_dense.add(key)
            score_gb = q.shape[0] * q.shape[2] * t_full * t_full * 4 / 1024**3
            logging.getLogger(__name__).warning(
                "dense_attention at T=%d materializes a [%d, %d, %d, %d] f32 "
                "score matrix (~%.1f GiB)",
                t_full, q.shape[0], q.shape[2], t_full, t_full, score_gb,
            )
    if k.shape[2] != q.shape[2]:
        if q.shape[2] % k.shape[2] != 0:
            raise ValueError(
                f"query heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}"
            )
        rep = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        t = q.shape[1]
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
        scores = torch.where(mask[None, None], scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).float(), v.float())
    return out.transpose(1, 2).to(q.dtype)


def ring_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis: Any,
    causal: bool = True,
) -> torch.Tensor:
    """Per-rank ring attention body over ``axis`` (a ``MeshAxis``); q/k/v
    are this rank's sequence chunks ``[B, T_local, H, D]``, rotary-embedded
    with global positions.

    GQA: K/V may carry fewer heads; they rotate unexpanded and are
    broadcast up to the query heads inside each tile.  ``T_local % 128 ==
    0`` selects the flash tiles.  Returns the local output chunk
    ``[B, T_local, H, D]`` in q's type."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    hkv = k.shape[2]
    if h % hkv != 0:
        raise ValueError(f"query heads {h} not a multiple of kv heads {hkv}")
    if tq % 128 == 0 and tk % 128 == 0:
        from torchft_tpu_torch.ops.flash_attention import ring_flash_local

        return ring_flash_local(q, k, v, axis, causal)
    idx, size = axis.rank, axis.size
    rep = h // hkv
    scale = 1.0 / math.sqrt(d)
    o = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, tq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    kc, vc = k, v
    for s in range(size):
        kv_idx = (idx - s) % size
        kr, vr = kc, vc
        if rep > 1:
            kr = torch.repeat_interleave(kr, rep, dim=2)
            vr = torch.repeat_interleave(vr, rep, dim=2)
        # [B, H, Tq, Tk] tile: products of the input type's values with f32
        # accumulation; running statistics f32
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
        if causal:
            q_pos = idx * tq + torch.arange(tq, device=q.device)
            k_pos = kv_idx * tk + torch.arange(tk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            scores = torch.where(mask[None, None], scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = softmax_math.exp(scores - m_new[..., None])
        if causal:
            # a tile wholly in the future would otherwise add exp(0) = 1
            p = torch.where(mask[None, None], p, 0.0)
        corr = softmax_math.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype).float(), vr.float()
        )
        m = m_new
        if s < size - 1:  # the last hop would carry nothing back
            kc, vc = axis_ops.shift(axis, kc, vc)
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def sharded_attention(
    local_fn: "Callable[..., torch.Tensor]",
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Any,
    axis_name: str = "cp",
    causal: bool = True,
) -> torch.Tensor:
    """Run a sequence-parallel attention body (ring or Ulysses signature)
    on this rank's chunks ``[B, T_local, H, D]`` over the ``axis_name`` axis
    of the inner mesh ``mesh`` (an ``InnerMesh``)."""
    if mesh is None:
        raise ValueError(
            f"sequence-parallel attention requires a mesh with a "
            f"{axis_name!r} axis; got None"
        )
    if axis_name not in mesh.axis_names:
        raise ValueError(
            f"sequence-parallel attention requires a {axis_name!r} mesh axis; "
            f"this mesh has {mesh.axis_names}"
        )
    return local_fn(q, k, v, mesh.axis(axis_name), causal=causal)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Any,
    axis_name: str = "cp",
    causal: bool = True,
) -> torch.Tensor:
    """Ring attention on this rank's chunks over ``mesh`` axis
    ``axis_name`` (see :func:`sharded_attention`)."""
    return sharded_attention(
        ring_attention_local, q, k, v, mesh, axis_name, causal
    )


__all__ = [
    "dense_attention",
    "ring_attention",
    "ring_attention_local",
    "sharded_attention",
]
