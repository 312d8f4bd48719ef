"""Ulysses (DeepSpeed-style) all-to-all sequence parallelism.

PyTorch port of ``torchft_tpu/ops/ulysses.py``: where ring attention
rotates K/V chunks around the ``cp`` axis, Ulysses re-shards once per
direction with an all-to-all (``MeshAxis.all_to_all``, tiled): scatter
heads and gather the sequence, run full-sequence attention on the local
head group, then the inverse all-to-all.  Local attention on the gathered
sequence is :func:`~torchft_tpu_torch.ops.flash_attention.flash_attention`
(kernels A, B and C at offset 0) when the global ``T % 128 == 0``, and
:func:`~torchft_tpu_torch.ops.ring_attention.dense_attention` otherwise.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from torchft_tpu_torch.ops.ring_attention import dense_attention, sharded_attention
from torchft_tpu_torch.parallel import axis as axis_ops


def _replicated_kv_heads(h: int, hkv: int, size: int) -> int:
    """Smallest kv head count ``hkv' >= hkv`` that is a multiple of both
    ``hkv`` and ``size`` while still dividing ``h``: ``lcm(hkv, size)``
    (given ``h % hkv == 0`` and ``h % size == 0``, ``h`` is divisible by
    both, hence by their lcm)."""
    cand = math.lcm(hkv, size)
    assert h % cand == 0, (h, hkv, size)  # guaranteed by preconditions
    return cand


def ulysses_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis: Any,
    causal: bool = True,
) -> torch.Tensor:
    """Per-rank Ulysses body over ``axis`` (a ``MeshAxis``); q/k/v are
    this rank's sequence chunks ``[B, T_local, H, D]``, rotary-embedded
    with global positions.

    GQA: when ``H_kv`` divides over the axis, K/V cross the all-to-all
    unexpanded; otherwise they are first replicated to ``lcm(H_kv, size)``
    heads (contiguous repeat, so the GQA mapping survives the head split).
    Query heads must divide the axis size.  A global ``T % 128 == 0``
    selects the flash kernels.  Returns ``[B, T_local, H, D]``."""
    size = axis.size
    h, hkv = q.shape[2], k.shape[2]
    if h % size != 0:
        raise ValueError(
            f"ulysses attention needs query heads ({h}) divisible by the "
            f"sequence-parallel axis size ({size})"
        )
    if h % hkv != 0:
        raise ValueError(f"query heads {h} not a multiple of kv heads {hkv}")
    if hkv % size != 0:
        rep = _replicated_kv_heads(h, hkv, size) // hkv
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)

    def seq_gather(x: torch.Tensor) -> torch.Tensor:
        # [B, T_local, H, D] -> [B, T, H/size, D]: split heads over the axis,
        # concatenate the sequence chunks in axis order
        return axis_ops.all_to_all(axis, x, split_dim=2, concat_dim=1)

    qf, kf, vf = seq_gather(q), seq_gather(k), seq_gather(v)
    if qf.shape[1] % 128 == 0:
        from torchft_tpu_torch.ops.flash_attention import flash_attention

        out = flash_attention(qf, kf, vf, causal=causal)
    else:
        out = dense_attention(qf, kf, vf, causal=causal)
    # inverse: [B, T, H/size, D] -> [B, T_local, H, D]
    return axis_ops.all_to_all(axis, out, split_dim=1, concat_dim=2)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Any,
    axis_name: str = "cp",
    causal: bool = True,
) -> torch.Tensor:
    """Ulysses attention on this rank's chunks over ``mesh`` axis
    ``axis_name`` (see :func:`~torchft_tpu_torch.ops.ring_attention.
    sharded_attention`)."""
    return sharded_attention(
        ulysses_attention_local, q, k, v, mesh, axis_name, causal
    )


__all__ = ["ulysses_attention", "ulysses_attention_local"]
