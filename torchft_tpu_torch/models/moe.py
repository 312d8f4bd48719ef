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

Expert parallelism.  :func:`moe_param_specs` puts the experts over ``ep``
and their inner dims over ``fsdp`` and ``tp``; the router stays whole.
Under an inner mesh, ``moe_ffn``'s ``group`` (:class:`MoEGroup`) says how
the layer's tokens and experts lie over it.  The JAX package routes the
global batch under ``jit`` and lets GSPMD move the ``[E, C, d]`` buffers;
here each rank routes its own tokens with the global statistics, by hand:

- capacity ``C`` comes from the global token count, and each (token,
  choice) takes its slot in global token order (row-major over ``[B, T]``,
  all first choices before all second ones): each rank counts its tokens'
  choices per expert in each of its rows (and chunk), the counts are
  all-gathered over the group, and a row's slots start after every earlier
  (row, chunk) block's and every earlier choice's (:func:`counts_before`);
- a rank fills the slots of its own tokens in an ``[E, C, d]`` buffer; a
  reduce-scatter over ``ep`` and a sum over the group's other axes hand
  each ``ep`` rank the whole buffer of its ``E / ep`` experts (every slot
  holds one token, so the sums are exact); it runs its experts on every
  slot, and an all-gather over ``ep`` brings their outputs back to the
  tokens' owners for the combine.  The expert work is repeated on the
  group's ranks that share an ``ep`` index, as GSPMD's ``P(ep, ...)``
  buffer is;
- the aux loss takes ``fraction`` from the gathered counts and
  ``mean_prob`` from a sum of the ranks' probabilities over the group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from torchft_tpu_torch.parallel.axis import (
    MeshAxis,
    copy_to_axis,
    gather_shards,
    psum,
    reduce_from_axis,
    reduce_scatter,
)
from torchft_tpu_torch.utils.device import resolve_device

Params = Dict[str, torch.Tensor]

#: the inner mesh's axes the experts (ep) and their inner dims (fsdp, tp)
#: split over
EP_AXIS = "ep"
FSDP_AXIS = "fsdp"
TP_AXIS = "tp"


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


def moe_param_specs() -> "Dict[str, Tuple[Optional[str], ...]]":
    """Each MoE leaf's partition, per dim of its JAX layout (which the port
    keeps): the experts over ``ep``, their inner dims over ``fsdp`` and
    ``tp``, the router whole (``torchft_tpu/models/moe.py``
    ``moe_param_specs``)."""
    ep, fs, tp = EP_AXIS, FSDP_AXIS, TP_AXIS
    return {
        "router": (None, None),
        "w_gate": (ep, fs, tp),
        "w_up": (ep, fs, tp),
        "w_down": (ep, tp, fs),
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


def _top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Each token's ``top_k`` experts, ties to the lower index (a stable
    descending sort's first ``k``, as ``jax.lax.top_k`` breaks them)."""
    return torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :top_k]


def block_counts(top_idx: torch.Tensor, n_experts: int, rows: int) -> torch.Tensor:
    """``[rows, k, E]`` int32: how many of each of ``rows`` equal runs of
    tokens chose each expert, per choice."""
    n, k = top_idx.shape
    experts = torch.arange(n_experts, device=top_idx.device)
    onehot = (top_idx.reshape(rows, n // rows, k)[..., None] == experts).to(torch.int32)
    return onehot.sum(dim=1, dtype=torch.int32)


def counts_before(counts: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """From every block's counts ``[n_blocks, k, E]`` (blocks in global
    token order), the (token, choice) assignments to each expert that come
    before each of ``blocks``' first token, per choice: all earlier
    choices' and this choice's earlier blocks'.  ``[len(blocks), k, E]``
    int32."""
    total = counts.sum(dim=0, dtype=torch.int32)  # [k, E]
    earlier_choices = torch.cumsum(total, dim=0, dtype=torch.int32) - total
    earlier_blocks = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts
    return earlier_blocks[blocks] + earlier_choices[None]


def route(
    logits: torch.Tensor, probs: torch.Tensor, n_experts: int, top_k: int,
    capacity: int, before: "Optional[torch.Tensor]" = None,
) -> Routing:
    """Top-k capacity routing of ``logits [N, E]`` (f32) with their softmax
    ``probs``.  Ties go to the lower expert index, as ``jax.lax.top_k``
    breaks them.  Earlier choices get capacity first, then token order;
    positions count in int32.  (The softmax is an argument because no two
    libraries' ``exp`` agree to the bit: given the same logits and
    probabilities, this function gives the JAX package's routing
    exactly.)

    ``before`` ``[rows, k, E]`` (:func:`counts_before`) routes these tokens
    as a part of a larger global order: they split into ``rows`` equal runs,
    each contiguous in that order, and a run's slots for a choice start
    after ``before``'s count.  Without it the tokens are the whole order."""
    top_idx = _top_k(logits, top_k)
    gates = torch.stack([probs.gather(1, top_idx[:, kk:kk + 1])[:, 0] for kk in range(top_k)])
    total = gates[0]
    for kk in range(1, top_k):
        total = total + gates[kk]
    gates = gates / torch.clamp(total, min=1e-9)
    if before is None:
        before = counts_before(block_counts(top_idx, n_experts, 1),
                               torch.zeros(1, dtype=torch.long, device=logits.device))
    n, rows = logits.shape[0], before.shape[0]
    experts = torch.arange(n_experts, device=logits.device)
    positions = []
    for kk in range(top_k):
        # [E, rows, N / rows]: a one-hot by comparison (F.one_hot checks its
        # input's range, which waits for the device), scanned along its
        # inner dim (a scan along the outer dim of [N, E] runs E threads
        # over N)
        mask = (experts[:, None] == top_idx[None, :, kk]).to(torch.int32).reshape(
            n_experts, rows, n // rows)
        pos = torch.cumsum(mask, dim=2, dtype=torch.int32) - 1 + before[:, kk].t()[:, :, None]
        positions.append(pos.reshape(n_experts, n).gather(0, top_idx[None, :, kk])[0])
    position = torch.stack(positions, dim=1)
    return Routing(top_idx, position, position < capacity, gates)


@dataclasses.dataclass
class MoEGroup:
    """How one MoE layer's routing spans the inner mesh: ``rows``, the axes
    its token rows split over (outer first: ``dp``, ``fsdp``, ``ep``, as
    the JAX package's ``_batch_axes`` orders them); ``seq``, the ``cp`` axis
    when one routing spans the sequence chunks (None when each chunk routes
    on its own, as inside the pipeline); and the axes the experts and their
    weights split over."""

    rows: "Tuple[MeshAxis, ...]"
    seq: "Optional[MeshAxis]"
    ep: MeshAxis
    fsdp: MeshAxis
    tp: MeshAxis

    @property
    def spans(self) -> "Tuple[MeshAxis, ...]":
        """The axes one routing's tokens lie over."""
        return self.rows + ((self.seq,) if self.seq is not None else ())

    @property
    def replicas(self) -> "Tuple[MeshAxis, ...]":
        """The axes whose ranks add their slots into one expert buffer
        besides ``ep``."""
        return tuple(a for a in self.spans if a is not self.ep)


def global_counts(
    local: torch.Tensor, group: MoEGroup
) -> "Tuple[torch.Tensor, torch.Tensor]":
    """Every block's counts in global token order and this rank's blocks:
    ``local [rows, k, E]`` all-gathered over the group's row axes (inner
    first, so that rows come in ``_batch_axes`` order) and its ``seq``
    axis; a block is a (row, chunk), row-major.  Returns ``(counts
    [n_blocks, k, E], blocks [rows])``."""
    rows = local.shape[0]
    counts = local[:, None]  # [rows, chunks, k, E]
    for axis in reversed(group.rows):
        (counts,) = axis.all_gather([counts.contiguous()], [0])
    row0 = 0
    for axis in group.rows:
        row0 = row0 * axis.size + axis.rank
    chunk, chunks = 0, 1
    if group.seq is not None:
        (counts,) = group.seq.all_gather([counts.contiguous()], [1])
        chunk, chunks = group.seq.rank, group.seq.size
    blocks = (row0 * rows + torch.arange(rows, device=local.device)) * chunks + chunk
    return counts.reshape(-1, *local.shape[1:]), blocks


def _group_sum(x: torch.Tensor, group: MoEGroup) -> torch.Tensor:
    for axis in group.spans:
        x = psum(axis, x)
    return x


def _experts(
    buf: torch.Tensor, params: "Mapping[str, torch.Tensor]", cfg: MoEConfig,
    group: "Optional[MoEGroup]",
) -> torch.Tensor:
    """SwiGLU of each expert of ``params`` over its slots ``buf [E', C,
    d]`` (compute dtype).  With a group, the experts' weights are this
    rank's shards: gathered whole over ``fsdp`` in the compute dtype (their
    gradients reduce-scattered back in f32), split over ``tp`` as the dense
    FFN is (the hidden dim column-parallel, the output a psum of f32 partial
    products rounded once)."""
    act = cfg.dtype
    if group is None:
        wg, wu, wd = (params[n].to(act) for n in ("w_gate", "w_up", "w_down"))
    else:
        wg, wu, wd = gather_shards(
            group.fsdp, [params["w_gate"], params["w_up"], params["w_down"]],
            [1, 1, 2], [act, act, act])
        buf = copy_to_axis(group.tp, buf)
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    if group is None or group.tp.size == 1:
        return torch.bmm(h, wd)
    return reduce_from_axis(group.tp, torch.bmm(h.float(), wd.float())).to(act)


def moe_ffn_stats(
    x: torch.Tensor, params: "Mapping[str, torch.Tensor]", cfg: MoEConfig,
    group: "Optional[MoEGroup]" = None,
) -> "Tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """:func:`moe_ffn` plus the dropped share of the token choices (a
    detached scalar): ``(y, aux, dropped)``."""
    b, t, d = x.shape
    n = b * t
    ne, k = cfg.n_experts, cfg.top_k
    act = cfg.dtype

    flat = x.reshape(n, d)
    # routing in f32 always
    logits = flat.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    if group is None:
        cap = _capacity(n, cfg)
        routing = route(logits, probs, ne, k, cap)
        # load-balance aux loss (Switch eq. 4) over the FIRST choice
        fraction = (routing.top_idx[:, 0:1] == torch.arange(ne, device=x.device)).float().mean(dim=0)
        aux = ne * torch.sum(fraction * probs.mean(dim=0))
        dropped = 1.0 - routing.kept.float().mean()
    else:
        counts, blocks = global_counts(block_counts(_top_k(logits, k), ne, b), group)
        n_all = counts.shape[0] * t
        cap = _capacity(n_all, cfg)
        routing = route(logits, probs, ne, k, cap, counts_before(counts, blocks))
        total = counts.sum(dim=0)  # [k, E]
        fraction = total[0].float() / n_all
        aux = ne * torch.sum(fraction * (_group_sum(probs.sum(dim=0), group) / n_all))
        kept = torch.clamp(total.sum(dim=0), max=cap).sum()
        dropped = 1.0 - kept.float() / (n_all * k)

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
    if group is not None:
        # this ep rank's experts' slots, filled by every rank of the group
        expert_in = reduce_scatter(group.ep, expert_in, 0)
        for axis in group.replicas:
            expert_in = psum(axis, expert_in)
    expert_out = _experts(expert_in, params, cfg, group)
    if group is not None:
        (expert_out,) = gather_shards(group.ep, [expert_out], [0], [None])
    expert_out = expert_out.reshape(ne * cap, d)

    # combine: each token's kept choices times their gates, summed in f32
    out_rows = torch.cat([expert_out, expert_out.new_zeros(1, d)])
    weights = routing.gates.t() * routing.kept  # [N, k]
    y = weights[:, 0:1] * torch.index_select(out_rows, 0, slot[:, 0]).float()
    for kk in range(1, k):
        y = y + weights[:, kk:kk + 1] * torch.index_select(out_rows, 0, slot[:, kk]).float()
    return y.reshape(b, t, d).to(x.dtype), aux, dropped.detach()


def moe_ffn(
    x: torch.Tensor, params: "Mapping[str, torch.Tensor]", cfg: MoEConfig,
    group: "Optional[MoEGroup]" = None,
) -> "Tuple[torch.Tensor, torch.Tensor]":
    """MoE feed-forward: ``x [B, T, d] -> (y [B, T, d], aux_loss scalar)``.
    Gradients reach the router through the gates and the aux's mean
    probability only; the choice of experts carries none.  With ``group``
    (:class:`MoEGroup`), ``x`` is this rank's rows (and chunk) and
    ``params`` its shards (:func:`moe_param_specs`); routing, capacity and
    aux are those of the group's global batch, the same on every rank."""
    y, aux, _ = moe_ffn_stats(x, params, cfg, group)
    return y, aux


def moe_ffn_reference(
    x: torch.Tensor, params: "Mapping[str, torch.Tensor]", cfg: MoEConfig
) -> torch.Tensor:
    """Brute-force per-token reference (no capacity drops): for tests."""
    b, t, d = x.shape
    flat = x.reshape(b * t, d).float()
    logits = flat @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_idx = _top_k(logits, cfg.top_k)
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
    "EP_AXIS",
    "FSDP_AXIS",
    "TP_AXIS",
    "MoEConfig",
    "MoEGroup",
    "Routing",
    "block_counts",
    "counts_before",
    "global_counts",
    "init_moe_params",
    "moe_ffn",
    "moe_ffn_reference",
    "moe_ffn_stats",
    "moe_param_specs",
    "route",
]
