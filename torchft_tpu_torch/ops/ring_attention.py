"""Plain attention over the full sequence.

Port of ``dense_attention`` from ``torchft_tpu/ops/ring_attention.py``; the
ring and Ulysses sequence-parallel paths of that module are not ported yet.
"""

from __future__ import annotations

import logging
import math

import torch

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
