"""Mixture-of-Experts FFN: capacity-based top-k routing.

PyTorch port of ``torchft_tpu/models/moe.py`` (GShard-style routing):
top-k (default 2) experts per token, gates renormalized over the chosen
k; per-expert capacity ``C = ceil(capacity_factor * N * k / E)``; a token
past capacity is dropped (its combine weight is zero, so the residual
passes it through unchanged).  The load-balance auxiliary loss
(``E * sum_e fraction_e * mean_prob_e`` over the first choice) is
returned for the trainer to add.

What differs from the JAX package:

- The JAX package builds dense ``[N, E, C]`` f32 one-hot dispatch and
  combine tensors and contracts them on the MXU.  Here dispatch is a
  slot-to-token map and a gather, and combine gathers each token's
  ``top_k`` expert rows and sums them times their gates in f32.  Every
  dispatch slot holds at most one token, so the gather gives the bits of
  the one-hot product; with ``top_k <= 2`` a combine sum has at most two
  non-zero terms, so its order cannot change the result.
- ``jax.lax.top_k`` picks the lower index among equal logits;
  ``torch.topk`` promises nothing about ties, so the choice is a stable
  descending sort's first ``k``.
- The routing logits are an f32 product; TF32 must stay off on the card
  (PyTorch's default), or near-ties route differently.
- Expert parallelism (``moe_param_specs``, ``moe_ffn``'s ``mesh``) needs
  the in-group axes, which are not ported yet; this layer runs on one
  device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from torchft_tpu_torch.utils.device import resolve_device

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32


def init_moe_params(
    generator: torch.Generator,
    cfg: MoEConfig,
    n_layers: int = 0,
    device: "str | torch.device" = "cuda",
) -> Params:
    """Router and expert weights ~ N(0, 1/fan_in), drawn on the CPU from
    ``generator`` and moved to ``device``; ``n_layers > 0`` adds a leading
    stacked layer dim.  Layout as the JAX package's: ``router [d, E]``,
    ``w_gate``/``w_up [E, d, f]``, ``w_down [E, f, d]``."""
    dev = resolve_device(device)
    e, f, ne = cfg.d_model, cfg.d_ff, cfg.n_experts
    lead = (n_layers,) if n_layers else ()

    def dense(*shape: int) -> torch.Tensor:
        w = torch.randn(shape, generator=generator) / math.sqrt(shape[-2])
        return w.to(device=dev, dtype=cfg.param_dtype)

    return {
        "router": dense(*lead, e, ne),
        "w_gate": dense(*lead, ne, e, f),
        "w_up": dense(*lead, ne, e, f),
        "w_down": dense(*lead, ne, f, e),
    }


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    return max(
        1, math.ceil(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    )


class Routing(NamedTuple):
    """Each (token, choice)'s expert, slot and gate: ``top_idx``,
    ``position`` (int32 slot within the expert) and ``kept`` are ``[N, k]``;
    ``gates`` is ``[k, N]`` f32, as the JAX package stacks them."""

    top_idx: torch.Tensor
    position: torch.Tensor
    kept: torch.Tensor
    gates: torch.Tensor


def route(
    logits: torch.Tensor, probs: torch.Tensor, n_experts: int, top_k: int,
    capacity: int,
) -> Routing:
    """Top-k capacity routing of ``logits [N, E]`` (f32) with their softmax
    ``probs``.  Ties go to the lower expert index, as ``jax.lax.top_k``
    breaks them.  Earlier choices get capacity first, then token order;
    positions count in int32.  (The softmax is an argument because no two
    libraries' ``exp`` agree to the bit: given the same logits and
    probabilities, this function gives the JAX package's routing
    exactly.)"""
    top_idx = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :top_k]
    gates = torch.stack([probs.gather(1, top_idx[:, kk:kk + 1])[:, 0] for kk in range(top_k)])
    total = gates[0]
    for kk in range(1, top_k):
        total = total + gates[kk]
    gates = gates / torch.clamp(total, min=1e-9)
    experts = torch.arange(n_experts, device=logits.device)
    prev = torch.zeros(n_experts, dtype=torch.int32, device=logits.device)
    positions = []
    for kk in range(top_k):
        # [E, N]: a one-hot by comparison (F.one_hot checks its input's
        # range, which waits for the device), scanned along its inner dim
        # (a scan along the outer dim of [N, E] runs E threads over N)
        mask = (experts[:, None] == top_idx[None, :, kk]).to(torch.int32)
        pos = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1 + prev[:, None]
        prev = prev + mask.sum(dim=1, dtype=torch.int32)
        positions.append(pos.gather(0, top_idx[None, :, kk])[0])
    position = torch.stack(positions, dim=1)
    return Routing(top_idx, position, position < capacity, gates)


def moe_ffn_stats(
    x: torch.Tensor, params: "Mapping[str, torch.Tensor]", cfg: MoEConfig
) -> "Tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """:func:`moe_ffn` plus the dropped share of the token choices (a
    detached scalar): ``(y, aux, dropped)``."""
    b, t, d = x.shape
    n = b * t
    ne, k = cfg.n_experts, cfg.top_k
    cap = _capacity(n, cfg)
    act = cfg.dtype

    flat = x.reshape(n, d)
    # routing in f32 always
    logits = flat.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    routing = route(logits, probs, ne, k, cap)
    # load-balance aux loss (Switch eq. 4) over the FIRST choice
    fraction = (routing.top_idx[:, 0:1] == torch.arange(ne, device=x.device)).float().mean(dim=0)
    aux = ne * torch.sum(fraction * probs.mean(dim=0))
    dropped = 1.0 - routing.kept.float().mean()

    # dispatch: slot e*C + position holds one token; empty slots (and the
    # dump slot E*C that dropped choices write to) read the zero row n
    slot = routing.top_idx * cap + routing.position  # [N, k]
    slot = torch.where(routing.kept, slot, ne * cap)
    tokens = torch.arange(n, device=x.device).expand(k, n).t()
    slot_token = torch.full((ne * cap + 1,), n, dtype=torch.long, device=x.device)
    slot_token.scatter_(0, slot.reshape(-1), tokens.reshape(-1))
    # a dropped choice writes the dump slot; reset it to the zero row
    slot_token[ne * cap] = n
    # index_select, not indexing: its backward adds with atomics, where
    # indexing's sorts every index (the zero row's many included); a real
    # row receives at most top_k terms, so the order cannot matter
    padded = torch.cat([flat.to(act), flat.new_zeros(1, d, dtype=act)])
    expert_in = torch.index_select(padded, 0, slot_token[: ne * cap]).reshape(ne, cap, d)

    h = F.silu(torch.bmm(expert_in, params["w_gate"].to(act))) * torch.bmm(
        expert_in, params["w_up"].to(act)
    )
    expert_out = torch.bmm(h, params["w_down"].to(act)).reshape(ne * cap, d)

    # combine: each token's kept choices times their gates, summed in f32
    out_rows = torch.cat([expert_out, expert_out.new_zeros(1, d)])
    weights = routing.gates.t() * routing.kept  # [N, k]
    y = weights[:, 0:1] * torch.index_select(out_rows, 0, slot[:, 0]).float()
    for kk in range(1, k):
        y = y + weights[:, kk:kk + 1] * torch.index_select(out_rows, 0, slot[:, kk]).float()
    return y.reshape(b, t, d).to(x.dtype), aux, dropped.detach()


def moe_ffn(
    x: torch.Tensor, params: "Mapping[str, torch.Tensor]", cfg: MoEConfig
) -> "Tuple[torch.Tensor, torch.Tensor]":
    """MoE feed-forward: ``x [B, T, d] -> (y [B, T, d], aux_loss scalar)``.
    Gradients reach the router through the gates and the aux's mean
    probability only; the choice of experts carries none."""
    y, aux, _ = moe_ffn_stats(x, params, cfg)
    return y, aux


def moe_ffn_reference(
    x: torch.Tensor, params: "Mapping[str, torch.Tensor]", cfg: MoEConfig
) -> torch.Tensor:
    """Brute-force per-token reference (no capacity drops): for tests."""
    b, t, d = x.shape
    flat = x.reshape(b * t, d).float()
    logits = flat @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_idx = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, : cfg.top_k]
    gates = probs.gather(1, top_idx)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    all_out = torch.stack([
        (F.silu(flat @ params["w_gate"][e].float()) * (flat @ params["w_up"][e].float()))
        @ params["w_down"][e].float()
        for e in range(cfg.n_experts)
    ])  # [E, N, d]
    rows = torch.arange(b * t, device=x.device)
    out = torch.zeros_like(flat)
    for kk in range(cfg.top_k):
        out = out + gates[:, kk:kk + 1] * all_out[top_idx[:, kk], rows]
    return out.reshape(b, t, d).to(x.dtype)


__all__ = [
    "MoEConfig",
    "Routing",
    "init_moe_params",
    "moe_ffn",
    "moe_ffn_reference",
    "moe_ffn_stats",
    "route",
]
