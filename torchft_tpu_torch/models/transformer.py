"""Flagship model: a llama-style decoder-only transformer.

PyTorch port of ``torchft_tpu/models/transformer.py``: bf16 compute with
f32 parameters, RMSNorm, rotary embeddings (half-split), GQA attention,
SwiGLU FFN (or, with ``n_experts > 0``, the MoE layer of
``models/moe.py``) and a tied embedding/output head.  The JAX package stacks the
layers' weights on a leading ``[n_layers]`` axis and scans over them; here
each layer is a :class:`Block` module and the forward loops over them
(``convert.py`` maps between the two layouts).  Attention runs through
``attn_impl``: ``"flash"`` (the hand-written CUDA kernels), ``"dense"``,
``"ring"`` or ``"ulysses"`` (sequence parallel over the inner mesh's ``cp``
axis), or ``"auto"`` (ring when the mesh has ``cp > 1``, else flash on CUDA
when ``T % 128 == 0``, else dense).

Context parallelism.  With an inner mesh (``parallel/axis.py``
``InnerMesh``; ``ManagedDeviceMesh.mesh``), :func:`loss_fn` and
:func:`make_grad_step` take the replica group's whole ``[B, T]`` token
array; each rank slices its batch rows (``dp``) and its sequence chunk
(``cp``) with the next-token targets that cross into the next chunk, runs
the model on the chunk at global rotary positions, and the gradients of the
replicated weights are summed over the inner axes (``jit`` sums them
implicitly in the JAX package).

Weight sharding (fsdp, tp).  :func:`param_specs` gives each parameter the
JAX package's partition (its ``param_specs`` in this layout, whose matrices
are ``[out, in]``) and :func:`shard_params` keeps only this rank's block of
each: the module's parameters are then shard-shaped, and AdamW, being
elementwise, steps on the shards unchanged.  Sharding is written by hand
over the mesh axes (``parallel/axis.py``), where the JAX package leaves it
to GSPMD:

- ``fsdp``: rows of the batch split over it (with ``dp``), and each
  block's weights, cast to the compute dtype first, are all-gathered in the
  block's forward (again in the recompute under remat); the gather's
  backward reduce-scatters the gradients back to the shards;
- ``tp``: ``wq``/``wk``/``wv``/``w_gate``/``w_up`` are column-parallel and
  ``wo``/``w_down`` row-parallel (identity forward / psum backward before
  the first, psum forward after the second); attention runs on the rank's
  ``n_heads / tp`` heads (kernels A-C under ``attn_impl="flash"``).  When
  ``tp`` does not divide ``n_kv_heads``, ``wk`` and ``wv`` are gathered over
  ``tp`` and the K/V heads expanded before the rank picks its own, so no
  head is split across ranks (``_expand_kv_for_tp`` of the JAX package);
- the tied embedding is split ``(tp, fsdp)``: the lookup gives zero outside
  the rank's vocabulary rows and is summed over ``tp``; the head and the
  loss are vocab-parallel (each rank's ``V / tp`` logits, the logsumexp
  from a max and a sum over ``tp``, the target's logit from its owner).

Expert parallelism (ep).  ``ep`` joins the batch axes (rows split over
``dp``, ``fsdp``, ``ep``, the JAX package's ``_batch_axes``); a MoE block's
experts split over it (``models/moe.py`` ``moe_param_specs``, ``MoEGroup``:
routing, capacity and aux from the global batch, the expert buffers handed
to their experts' ``ep`` ranks and back).  The router and the attention
weights, whole on every ``ep`` rank, have their gradients summed over it.

Pipeline parallelism (pp).  :func:`shard_params` keeps a ``pp`` rank's
``n_layers / pp`` consecutive blocks (keyed by their global index, so
parameter names stay those of the whole model) beside the replicated
embedding and final norm; :func:`forward_pipelined` runs them as a GPipe
schedule (``parallel/pipeline.py``) with the embedding on the first stage
and the head on the last, and with a ``pp`` mesh :func:`loss_fn` and
:func:`make_grad_step` take that path.  The stages run attention through
``attn_impl`` as :func:`Transformer.forward` does, kernels A-C included:
the JAX package keeps its pipeline's blocks on the plain tile body because
its partial-manual ``shard_map`` cannot lower Pallas, a limit of its
compiler that the port does not share.  Inside the pipe a MoE layer routes
each microbatch on its own (and, under ``cp``, each sequence chunk, with
its aux averaged over ``cp``), as the JAX package's does.

Rematerialization: ``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``).  ``remat_policy="full"`` keeps only the block
inputs; ``"dots"`` is the JAX package's ``dots_saveable``: selective
activation checkpointing keeps every matmul's output (``aten.mm``,
``addmm``, ``bmm``), kernel A's (the flash forward op, on every ring tile
too) and the ring's and Ulysses' exchanges' (``mesh_shift``,
``mesh_all_to_all``), and recomputes only the elementwise work between
them: under ``cp`` the recompute moves no byte.  That is a memory choice
(the exchanged K/V chunks are kept); the values are those of ``"full"``.
Other collectives (the fsdp gathers, the tp sums, the MoE routing
statistics and expert buffers) are repeated in the recompute, in the same
order on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from torchft_tpu_torch.models.moe import (
    EP_AXIS,
    FSDP_AXIS,
    TP_AXIS,
    MoEConfig,
    MoEGroup,
    moe_ffn_stats,
    moe_param_specs,
)
from torchft_tpu_torch.ops import softmax_math
from torchft_tpu_torch.ops.flash_attention import flash_attention, flash_fwd_op
from torchft_tpu_torch.ops.ring_attention import (
    dense_attention,
    ring_attention,
)
from torchft_tpu_torch.ops.ulysses import ulysses_attention
from torchft_tpu_torch.parallel import pipeline
from torchft_tpu_torch.parallel.axis import (
    EXCHANGE_OPS,
    MeshAxis,
    copy_to_axis,
    gather_shards,
    psum,
    reduce_from_axis,
)
from torchft_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

#: the inner mesh's axis names: batch, sequence and pipeline stages here;
#: the two that shard weights (fsdp, tp) and experts (ep) from models/moe.py
DP_AXIS = "dp"
CP_AXIS = "cp"
PP_AXIS = "pp"
#: the axes the batch rows split over, in the JAX package's order
#: (``_batch_axes``: the row block is ``(dp_index * fsdp + fsdp_index) * ep
#: + ep_index``)
BATCH_AXES = (DP_AXIS, FSDP_AXIS, EP_AXIS)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 1408
    n_layers: int = 6
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # remat=True recomputes each block in the backward; remat_policy
    # "full" keeps the block inputs only, "dots" also every matmul output
    remat: bool = True
    remat_policy: str = "full"
    # "auto", "flash", "dense", "ring" or "ulysses" (module docstring)
    attn_impl: str = "auto"
    # n_experts > 0 replaces the dense FFN with a MoE layer (top-k routed;
    # see models/moe.py); loss_fn adds moe_aux_weight times its aux loss
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# ---------------------------------------------------------------------------
# rematerialization
# ---------------------------------------------------------------------------

#: the ops whose outputs ``remat_policy="dots"`` keeps: the matmuls and
#: kernel A (``jax.checkpoint_policies.dots_saveable`` keeps dot outputs),
#: and the ring's and Ulysses' exchanges, so that the recompute issues none
_DOT_OPS = frozenset({
    torch.ops.aten.mm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default,
    torch.ops.aten.baddbmm.default,
    flash_fwd_op._opoverload,
    *EXCHANGE_OPS,
})


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op in _DOT_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


# ---------------------------------------------------------------------------
# weight sharding (fsdp, tp)
# ---------------------------------------------------------------------------

#: per dim of a ``[out, in]`` matrix: column-parallel (``wq``, ``wk``,
#: ``wv``, ``w_gate``, ``w_up``; JAX ``P(None, fsdp, tp)`` on ``[L, in,
#: out]``) and row-parallel (``wo``, ``w_down``; JAX ``P(None, tp, fsdp)``)
_COLUMN = (TP_AXIS, FSDP_AXIS)
_ROW = (FSDP_AXIS, TP_AXIS)
#: a dense block's matrices, in the order of the block's parameters
_BLOCK_SPECS = {
    "wq": _COLUMN, "wk": _COLUMN, "wv": _COLUMN, "wo": _ROW,
    "w_gate": _COLUMN, "w_up": _COLUMN, "w_down": _ROW,
}
_warned_replicated: set = set()


def _axis_names(mesh: Any) -> "Tuple[str, ...]":
    """An :class:`~torchft_tpu_torch.parallel.axis.InnerMesh`'s axis names,
    or a mesh shape's (``{"fsdp": 2, "tp": 2}``) keys."""
    names = getattr(mesh, "axis_names", None)
    return tuple(names) if names is not None else tuple(mesh)


def param_specs(
    cfg: TransformerConfig, mesh: Any = None
) -> "Dict[str, Tuple[Optional[str], ...]]":
    """Each parameter's partition, by name: the mesh axis each of its dims
    is split over, or None.  The JAX package's ``param_specs`` in the
    port's layout (matrices ``[out, in]``, one entry a layer): the tied
    embedding ``(tp, fsdp)``, column-parallel matrices ``(tp, fsdp)``,
    row-parallel ones ``(fsdp, tp)``, the norms whole, a MoE block's leaves
    as ``moe_param_specs`` says (experts over ``ep``).  The layers split
    over ``pp`` by block, not by dim (:func:`shard_params`).  With a
    ``mesh`` (an inner mesh or a mesh shape), axes it does not name are
    dropped, and a mesh with neither ``fsdp`` nor ``tp`` is warned about
    once, as the JAX package does (weights then stay whole on every
    rank)."""
    specs: "Dict[str, Tuple[Optional[str], ...]]" = {"embed": (TP_AXIS, FSDP_AXIS)}
    moe = moe_param_specs() if cfg.n_experts else {}
    for layer in range(cfg.n_layers):
        specs[f"blocks.{layer}.attn_norm"] = (None,)
        for name, spec in _BLOCK_SPECS.items():
            if name == "w_gate":
                specs[f"blocks.{layer}.mlp_norm"] = (None,)
                if moe:
                    for leaf, leaf_spec in moe.items():
                        specs[f"blocks.{layer}.{leaf}"] = leaf_spec
                    break
            specs[f"blocks.{layer}.{name}.weight"] = spec
    specs["final_norm"] = (None,)
    if mesh is None:
        return specs
    names = _axis_names(mesh)
    if FSDP_AXIS not in names and TP_AXIS not in names and names not in _warned_replicated:
        _warned_replicated.add(names)
        logger.warning(
            "mesh %s has neither the %r nor the %r axis: parameters stay "
            "whole on every rank", names, FSDP_AXIS, TP_AXIS)
    return {
        n: tuple(a if a in names else None for a in spec) for n, spec in specs.items()
    }


class StageBlocks(nn.ModuleDict):
    """A pipeline stage's blocks, keyed by their global layer index (so
    that parameter names are the whole model's); iterates over the blocks
    in order and indexes by layer."""

    def __iter__(self) -> "Iterator[nn.Module]":
        return iter(self.values())

    def __getitem__(self, layer: "int | str") -> nn.Module:
        return super().__getitem__(str(layer))

    def layers(self) -> "list":
        return [int(k) for k in self.keys()]


def stage_range(cfg: TransformerConfig, mesh: Any) -> range:
    """The layers this rank's ``pp`` stage holds."""
    pp = _axis(mesh, PP_AXIS)
    if cfg.n_layers % pp.size:
        raise ValueError(f"layer count {cfg.n_layers} not divisible by pp axis size {pp.size}")
    per = cfg.n_layers // pp.size
    return range(pp.rank * per, (pp.rank + 1) * per)


def _local_block(
    t: torch.Tensor, spec: "Tuple[Optional[str], ...]", mesh: Any
) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec``."""
    for dim, name in enumerate(spec):
        if name is None or mesh.axis_size(name) == 1:
            continue
        n, size = t.shape[dim], mesh.axis_size(name)
        if n % size:
            raise ValueError(
                f"dim {dim} of {tuple(t.shape)} does not split over {name}={size}")
        t = t.narrow(dim, mesh.axis_index(name) * (n // size), n // size)
    return t


def shard_params(model: "Transformer", mesh: Any) -> "Transformer":
    """Keep only this rank's block of each parameter (:func:`param_specs`
    over the inner ``mesh``), and under ``pp`` only its stage's blocks
    (:class:`StageBlocks`), in place; returns ``model``.  Every rank starts
    from the same whole weights (one seed), as ``jax.device_put`` of one
    array to a ``NamedSharding`` does."""
    cfg = model.cfg
    if tuple(model.embed.shape) != (cfg.vocab_size, cfg.d_model) or isinstance(
            model.blocks, StageBlocks):
        raise ValueError(f"model is already sharded (embed {tuple(model.embed.shape)})")
    if mesh.axis_size(PP_AXIS) > 1:
        model.blocks = StageBlocks(
            {str(l): model.blocks[l] for l in stage_range(cfg, mesh)})
    specs = param_specs(cfg, mesh)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = _local_block(p.data, specs[name], mesh).clone()
    return model


def _layer_of(name: str) -> "Optional[Tuple[int, str]]":
    """``(layer, rest)`` of a block parameter's name, else None."""
    if not name.startswith("blocks."):
        return None
    layer, rest = name[len("blocks."):].split(".", 1)
    return int(layer), rest


def gather_params(
    named: "Mapping[str, torch.Tensor]", cfg: TransformerConfig, mesh: Any,
    keep: bool = True,
) -> "Dict[str, torch.Tensor]":
    """The inverse of :func:`shard_params`, collective: each of this rank's
    shards in ``named`` (its parameters, or anything keyed by their names,
    such as its gradients) made whole by gathering it over the axes its
    :func:`param_specs` entry splits it on, leaf by leaf, and under ``pp``
    every stage's blocks gathered beside this stage's.  Every rank of the
    group calls it; with ``keep=False`` a rank takes part in the gathers
    but holds none of the whole tensors (and returns ``{}``)."""
    specs = param_specs(cfg, mesh)
    pp = mesh.axis(PP_AXIS)
    out = {}
    for name, t in named.items():
        whole = t.detach()
        for dim, axis in enumerate(specs[name]):
            if axis is not None and mesh.axis_size(axis) > 1:
                (whole,) = mesh.axis(axis).all_gather([whole.contiguous()], [dim])
        layer = _layer_of(name)
        if pp.size > 1 and layer is not None:
            # every stage holds the same leaves of its own layers, in order
            (stages,) = pp.all_gather([whole[None].contiguous()], [0])
            per = cfg.n_layers // pp.size
            local = layer[0] - pp.rank * per
            for s in range(pp.size) if keep else ():
                out[f"blocks.{s * per + local}.{layer[1]}"] = stages[s]
            continue
        if keep:
            out[name] = whole
    return out


def _axis(mesh: Any, name: str) -> MeshAxis:
    return mesh.axis(name) if mesh is not None else MeshAxis(name, None, 0, 1)


def _check_shards(model: "Transformer", mesh: Any) -> None:
    cfg = model.cfg
    want = (cfg.vocab_size // mesh.axis_size(TP_AXIS),
            cfg.d_model // mesh.axis_size(FSDP_AXIS))
    layers = list(stage_range(cfg, mesh))
    held = model.blocks.layers() if isinstance(model.blocks, StageBlocks) else list(
        range(len(model.blocks)))
    experts = [b.w_gate.shape[0] for b in model.blocks] if cfg.n_experts else []
    if (tuple(model.embed.shape) != want or held != layers
            or any(e != cfg.n_experts // mesh.axis_size(EP_AXIS) for e in experts)):
        raise ValueError(
            f"parameters are not sharded for {mesh!r} (embed "
            f"{tuple(model.embed.shape)}, expected {want}; layers {held[:1]}..{held[-1:]}, "
            f"expected {layers[:1]}..{layers[-1:]}): call shard_params(model, mesh)")


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def _rms_norm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6)).to(x.dtype) * w.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split; x [B, T, H, D], positions [T] (global)."""
    d = x.shape[-1]
    exponent = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = 1.0 / (theta**exponent)
    angles = positions[:, None].float() * freqs[None, :]  # [T, D/2]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _cp_size(mesh: Any) -> int:
    return mesh.axis_size(CP_AXIS) if mesh is not None else 1


def _resolve_attn_impl(
    cfg: TransformerConfig, seq_len: int, device: torch.device, mesh: Any = None
) -> str:
    if cfg.attn_impl != "auto":
        return cfg.attn_impl
    if _cp_size(mesh) > 1:
        return "ring"
    if device.type == "cuda" and seq_len % 128 == 0:
        return "flash"
    return "dense"


def _moe_cfg(cfg: TransformerConfig) -> MoEConfig:
    return MoEConfig(
        d_model=cfg.d_model,
        d_ff=cfg.d_ff,
        n_experts=cfg.n_experts,
        top_k=cfg.moe_top_k,
        capacity_factor=cfg.moe_capacity_factor,
        dtype=cfg.dtype,
        param_dtype=cfg.param_dtype,
    )


def _moe_group(mesh: Any, chunk_routing: bool) -> "Optional[MoEGroup]":
    """The MoE layer's group over the inner mesh: its rows over the batch
    axes, and its routing over the ``cp`` chunks too unless each chunk
    routes on its own (``chunk_routing``, inside the pipeline)."""
    if mesh is None or mesh.size == 1:
        return None
    return MoEGroup(
        rows=tuple(mesh.axis(a) for a in BATCH_AXES),
        seq=None if chunk_routing else mesh.axis(CP_AXIS),
        ep=mesh.axis(EP_AXIS), fsdp=mesh.axis(FSDP_AXIS), tp=mesh.axis(TP_AXIS),
    )


#: the MoE block's parameters, in the JAX package's layout (router
#: ``[d, E]``, experts ``[E, d, f]`` and ``[E, f, d]``)
MOE_LEAVES = ("router", "w_gate", "w_up", "w_down")


def _column_input(tp: MeshAxis, h: torch.Tensor) -> torch.Tensor:
    """The input of column-parallel matmuls, each of which casts it to the
    compute dtype itself: with ``tp``, its f32 copy under
    :func:`copy_to_axis`, so that the gradients of its uses add up in f32,
    over the uses and over the axis, and are rounded once."""
    return h if tp.size == 1 else copy_to_axis(tp, h.float())


@contextlib.contextmanager
def _tf32_if_exact(t: torch.Tensor) -> Iterator[None]:
    """TF32 tensor cores for the f32 matmuls of the block when ``t`` holds
    16-bit values on the card: a bf16 or f16 value is exact in TF32 and
    the products accumulate in f32, so only the speed changes.  f32
    values keep the SGEMM."""
    flags = torch.backends.cuda.matmul
    if t.device.type != "cuda" or t.dtype not in (torch.bfloat16, torch.float16):
        yield
        return
    was, flags.allow_tf32 = flags.allow_tf32, True
    try:
        yield
    finally:
        flags.allow_tf32 = was


class _RowProduct(torch.autograd.Function):
    """``x @ w.T`` of compute-dtype operands as an f32 product, and its
    gradients from an f32 output gradient that holds compute-dtype values
    (the gradient of the rounding after the sum).  Every operand is exact
    in TF32 on the card; the compute-dtype operands are saved, not f32
    copies."""

    @staticmethod
    def forward(ctx, x, w):  # type: ignore[override]
        ctx.save_for_backward(x, w)
        with _tf32_if_exact(x):
            return F.linear(x.float(), w.float())

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        x, w = ctx.saved_tensors
        with _tf32_if_exact(x):
            gx = g @ w.float()
            gw = g.flatten(0, -2).T @ x.float().flatten(0, -2)
        return gx.to(x.dtype), gw.to(w.dtype)


def _row_output(tp: MeshAxis, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` of a row-parallel matmul, summed over ``tp`` and rounded
    to ``x``'s dtype once, as the whole product is: each rank's partial
    product stays f32 until the sum (ROADMAP §C 15; the JAX package rounds
    it to the compute dtype first)."""
    if tp.size == 1:
        return F.linear(x, w)
    return reduce_from_axis(tp, _RowProduct.apply(x, w)).to(x.dtype)


class Block(nn.Module):
    """One decoder layer: attention then the FFN, both pre-norm with
    residuals; ``forward`` returns ``(x, aux)``, aux being the MoE layer's
    load-balance loss (0 for a dense FFN).  Dense weights are
    ``nn.Linear`` ``[out, in]`` in the param dtype and run in the
    activation dtype; MoE weights keep the JAX layout (:data:`MOE_LEAVES`).
    A MoE block keeps its last forward's aux loss and dropped share of
    token choices in ``moe_stats`` (``{"aux", "dropped"}``, detached
    scalars)."""

    def __init__(self, cfg: TransformerConfig, device: torch.device) -> None:
        super().__init__()
        e, f = cfg.d_model, cfg.d_ff
        hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        kw = dict(bias=False, device=device, dtype=cfg.param_dtype)
        self.cfg = cfg
        self.attn_norm = nn.Parameter(torch.ones(e, device=device, dtype=cfg.param_dtype))
        self.wq = nn.Linear(e, nh * hd, **kw)
        self.wk = nn.Linear(e, nkv * hd, **kw)
        self.wv = nn.Linear(e, nkv * hd, **kw)
        self.wo = nn.Linear(nh * hd, e, **kw)
        self.mlp_norm = nn.Parameter(torch.ones(e, device=device, dtype=cfg.param_dtype))
        if cfg.n_experts:
            self.moe_cfg = _moe_cfg(cfg)
            ne = cfg.n_experts
            for name, shape in zip(MOE_LEAVES, ((e, ne), (ne, e, f), (ne, e, f), (ne, f, e))):
                self.register_parameter(name, nn.Parameter(
                    torch.empty(shape, device=device, dtype=cfg.param_dtype)
                ))
            self.moe_stats: "Dict[str, torch.Tensor]" = {}
        else:
            self.w_gate = nn.Linear(e, f, **kw)
            self.w_up = nn.Linear(e, f, **kw)
            self.w_down = nn.Linear(f, e, **kw)

    def _attention(self, q, k, v, mesh: Any = None) -> torch.Tensor:
        cfg = self.cfg
        impl = _resolve_attn_impl(cfg, q.shape[1], q.device, mesh)
        if impl == "ring":
            return ring_attention(q, k, v, mesh, CP_AXIS)
        if impl == "ulysses":
            return ulysses_attention(q, k, v, mesh, CP_AXIS)
        if impl in ("flash", "dense") and _cp_size(mesh) > 1:
            raise ValueError(
                f"attn_impl={impl!r} needs the sequence unsharded; on a "
                f"{CP_AXIS!r} mesh use 'ring' or 'ulysses'"
            )
        if impl == "flash":
            return flash_attention(q, k, v, causal=True)
        if impl == "dense":
            return dense_attention(q, k, v, causal=True)
        raise ValueError(
            f"unknown attn_impl {impl!r}; "
            "expected 'dense', 'flash', 'ring', 'ulysses' or 'auto'"
        )

    def _weights(self, names, fsdp: MeshAxis, tp: MeshAxis) -> "Dict[str, torch.Tensor]":
        """The matrices ``names`` whole over ``fsdp``, gathered in one
        collective in the compute dtype (cast first: half the bytes; the
        gradients come back summed in f32).  ``wk`` and ``wv`` stay in the
        parameter dtype when :meth:`_kv` gathers them over ``tp`` too, so
        that their gradients are rounded once, not after each sum."""
        act = self.cfg.dtype
        expand = self.cfg.n_kv_heads % tp.size != 0
        shards = [getattr(self, n).weight for n in names]
        dims = [_BLOCK_SPECS[n].index(FSDP_AXIS) for n in names]
        dtypes = [None if expand and n in ("wk", "wv") else act for n in names]
        return dict(zip(names, gather_shards(fsdp, shards, dims, dtypes)))

    def _kv(self, h, wk, wv, tp: MeshAxis) -> "Tuple[torch.Tensor, torch.Tensor]":
        """K and V ``[B, T, heads, D]`` for this rank's query heads: its own
        KV heads when ``tp`` divides them, else (``_expand_kv_for_tp``) the
        whole ``wk``/``wv`` gathered over ``tp`` and the KV head of each of
        its query heads picked, so that no head is split across ranks."""
        cfg = self.cfg
        b, t, _ = h.shape
        nkv, hd = cfg.n_kv_heads, cfg.head_dim
        act = cfg.dtype
        if nkv % tp.size == 0:
            n = nkv // tp.size
            return (F.linear(h.to(act), wk).reshape(b, t, n, hd),
                    F.linear(h.to(act), wv).reshape(b, t, n, hd))
        wk, wv = gather_shards(tp, [wk, wv], [0, 0], [act, act])
        k = F.linear(h.to(act), wk).reshape(b, t, nkv, hd)
        v = F.linear(h.to(act), wv).reshape(b, t, nkv, hd)
        local = cfg.n_heads // tp.size
        heads = torch.arange(tp.rank * local, (tp.rank + 1) * local, device=h.device)
        pick = heads // (cfg.n_heads // nkv)
        return k.index_select(2, pick), v.index_select(2, pick)

    def forward(
        self, x: torch.Tensor, positions: torch.Tensor, mesh: Any = None,
        chunk_routing: bool = False,
    ) -> "Tuple[torch.Tensor, torch.Tensor]":
        """``mesh`` is the inner mesh ring/Ulysses attention runs over and
        the weights are sharded over; ``x`` is then this rank's rows and
        chunk, ``positions`` global.  A MoE FFN routes the group's whole
        batch, or each ``cp`` chunk on its own with ``chunk_routing``."""
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.head_dim
        fsdp, tp = _axis(mesh, FSDP_AXIS), _axis(mesh, TP_AXIS)
        names = ("wq", "wk", "wv", "wo") if cfg.n_experts else tuple(_BLOCK_SPECS)
        w = self._weights(names, fsdp, tp)
        act = cfg.dtype
        local = cfg.n_heads // tp.size
        h = _column_input(tp, _rms_norm(x, self.attn_norm))
        q = F.linear(h.to(act), w["wq"]).reshape(b, t, local, hd)
        k, v = self._kv(h, w["wk"], w["wv"], tp)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        attn = self._attention(q, k, v, mesh).reshape(b, t, local * hd)
        x = x + _row_output(tp, attn, w["wo"])
        h = _rms_norm(x, self.mlp_norm)
        if cfg.n_experts:
            params = {n: getattr(self, n) for n in MOE_LEAVES}
            group = _moe_group(mesh, chunk_routing)
            extra = () if group is None else (group,)
            y, aux, dropped = moe_ffn_stats(h, params, self.moe_cfg, *extra)
            self.moe_stats = {"aux": aux.detach(), "dropped": dropped}
            return x + y, aux
        h = _column_input(tp, h)
        gate = F.silu(F.linear(h.to(act), w["w_gate"]))
        up = F.linear(h.to(act), w["w_up"])
        x = x + _row_output(tp, gate * up, w["w_down"])
        return x, torch.zeros((), dtype=torch.float32, device=x.device)


class Transformer(nn.Module):
    """tokens ``[B, T]`` -> logits ``[B, T, vocab]`` (f32).  Parameters are
    created uninitialised; :func:`init_params` fills them."""

    def __init__(
        self, cfg: TransformerConfig, device: "str | torch.device" = "cuda"
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, device=dev, dtype=cfg.param_dtype)
        )
        self.blocks = nn.ModuleList(Block(cfg, dev) for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(
            torch.ones(cfg.d_model, device=dev, dtype=cfg.param_dtype)
        )

    def forward(
        self, tokens: torch.Tensor, return_aux: bool = False, mesh: Any = None
    ) -> "torch.Tensor | Tuple[torch.Tensor, torch.Tensor]":
        """``return_aux`` also returns the layers' summed MoE load-balance
        loss (0 for a dense FFN).  With an inner ``mesh``, ``tokens`` is
        this rank's rows and sequence chunk: rotary positions start at
        ``cp_rank * T_local``, attention runs over the ``cp`` axis, the
        parameters are this rank's shards (:func:`shard_params`) and, with
        ``tp > 1``, the logits are this rank's ``V / tp`` vocabulary
        columns.  A ``pp`` mesh takes :func:`forward_pipelined`."""
        cfg = self.cfg
        _check_mesh(cfg, mesh)
        if _axis(mesh, PP_AXIS).size > 1:
            raise ValueError(
                f"{mesh!r} has a {PP_AXIS!r} axis: run the stages with "
                "forward_pipelined(model, tokens, mesh, microbatches)")
        b, t = tokens.shape
        x, table = self._embed(tokens, mesh)
        positions = _positions(mesh, t, tokens.device)
        aux_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for block in self.blocks:
            x, aux = self._block(block, x, positions, mesh, False)
            aux_sum = aux_sum + aux
        logits = self._head(x, table, _axis(mesh, TP_AXIS))
        if return_aux:
            return logits, aux_sum
        return logits

    def _block(self, block: Block, x, positions, mesh: Any, chunk_routing: bool):
        """One block, recomputed in the backward under ``cfg.remat``."""
        cfg = self.cfg
        if cfg.remat and self.training:
            kw = {"context_fn": _dots_context} if cfg.remat_policy == "dots" else {}
            return checkpoint(block, x, positions, mesh, chunk_routing,
                              use_reentrant=False, **kw)
        return block(x, positions, mesh, chunk_routing)

    def _table(self, mesh: Any) -> "Optional[torch.Tensor]":
        """The tied table, whole over fsdp, in the compute dtype's values
        (f32), when the weights are sharded; else None."""
        fsdp, tp = _axis(mesh, FSDP_AXIS), _axis(mesh, TP_AXIS)
        if fsdp.size == 1 and tp.size == 1:
            return None
        _check_shards(self, mesh)
        (table,) = gather_shards(fsdp, [self.embed], [1], [self.cfg.dtype])
        return table.float()

    def _embed(
        self, tokens: torch.Tensor, mesh: Any
    ) -> "Tuple[torch.Tensor, Optional[torch.Tensor]]":
        """The tokens' embedding rows in the compute dtype, and the table
        :meth:`_table` gathered for them (the head takes it again)."""
        table = self._table(mesh)
        if table is None:
            # _embed: a gather of the activation-dtype table (same values
            # as casting the table first)
            return self.embed[tokens].to(self.cfg.dtype), None
        return _embed_local(table, tokens, _axis(mesh, TP_AXIS)).to(self.cfg.dtype), table

    def _head(
        self, x: torch.Tensor, table: "Optional[torch.Tensor]" = None,
        tp: "Optional[MeshAxis]" = None,
    ) -> torch.Tensor:
        """Final norm + tied output head with f32 logits.

        The JAX package multiplies in the activation dtype with f32
        accumulation (``preferred_element_type=float32``).  A bf16
        ``torch.matmul`` would round the logits to bf16, so both operands
        are rounded to the activation dtype and then multiplied in f32: a
        product of two bf16 values is exact in f32, so this is the same
        bf16-input, f32-accumulate product (TF32 must stay off, as it is by
        default).  Sharded, ``table`` is this rank's vocabulary rows of the
        table (whole over fsdp, the compute dtype's values in f32) and the
        logits are those rows' columns."""
        act = self.cfg.dtype
        x = _rms_norm(x, self.final_norm)
        if table is None:
            return torch.matmul(x.to(act).float(), self.embed.to(act).float().t())
        return torch.matmul(copy_to_axis(tp, x.to(act).float()), table.t())


def _positions(mesh: Any, t: int, device: torch.device) -> torch.Tensor:
    """Global rotary positions of this rank's chunk of ``t`` positions."""
    offset = mesh.axis_index(CP_AXIS) * t if mesh is not None else 0
    return offset + torch.arange(t, device=device)


def _embed_local(table: torch.Tensor, tokens: torch.Tensor, tp: MeshAxis) -> torch.Tensor:
    """The embedding rows of ``tokens`` from this rank's vocabulary block
    ``table`` (zero for tokens another ``tp`` rank owns), summed over
    ``tp``: each token's row comes from its owner, exactly."""
    if tp.size == 1:
        return table[tokens]
    vl = table.shape[0]
    idx = tokens - tp.rank * vl
    own = (idx >= 0) & (idx < vl)
    rows = torch.where(own[..., None], table[idx.clamp(0, vl - 1)], 0.0)
    return reduce_from_axis(tp, rows)


def init_params(
    generator: torch.Generator,
    cfg: TransformerConfig,
    device: "str | torch.device" = "cuda",
) -> Transformer:
    """A :class:`Transformer` initialised as the JAX package initialises its
    pytree: projections ~ N(0, 1/fan_in), the embedding ~ N(0, 0.02^2),
    norms at 1; MoE router and experts ~ N(0, 1/fan_in) in their JAX
    layout.  Values are drawn on the CPU from ``generator`` (a CPU
    generator), so a seed gives the same weights on every device."""
    model = Transformer(cfg, device)

    def normal(param: torch.Tensor, fan_in: int) -> None:
        param.copy_(torch.randn(param.shape, generator=generator) / fan_in**0.5)

    with torch.no_grad():
        model.embed.copy_(
            torch.randn(model.embed.shape, generator=generator) * 0.02
        )
        for block in model.blocks:
            for lin in (block.wq, block.wk, block.wv, block.wo):
                normal(lin.weight, lin.weight.shape[1])
            if cfg.n_experts:
                for name in MOE_LEAVES:
                    param = getattr(block, name)
                    normal(param, param.shape[-2])
            else:
                for lin in (block.w_gate, block.w_up, block.w_down):
                    normal(lin.weight, lin.weight.shape[1])
    return model


#: the inner axes the model runs over
MESH_AXES = (DP_AXIS, FSDP_AXIS, EP_AXIS, TP_AXIS, CP_AXIS, PP_AXIS)


def _check_mesh(cfg: TransformerConfig, mesh: Any) -> None:
    """The config's remat policy, and what an inner mesh must hold for it:
    only the axes of :data:`MESH_AXES`, sizes that split the heads, the
    experts and the layers."""
    if cfg.remat and cfg.remat_policy not in ("full", "dots"):
        raise ValueError(
            f"unknown remat_policy {cfg.remat_policy!r}; expected 'full' or 'dots'"
        )
    if mesh is None or mesh.size == 1:
        return
    unknown = [n for n in mesh.axis_names if n not in MESH_AXES and mesh.axis_size(n) > 1]
    if unknown:
        raise ValueError(f"inner mesh {mesh!r}: unknown axes {unknown}; expected {MESH_AXES}")
    tp, ep = mesh.axis_size(TP_AXIS), mesh.axis_size(EP_AXIS)
    if cfg.n_heads % tp:
        raise ValueError(f"{cfg.n_heads} query heads do not split over {TP_AXIS}={tp}")
    if cfg.n_experts % ep:
        raise ValueError(f"{cfg.n_experts} experts do not split over {EP_AXIS}={ep}")
    stage_range(cfg, mesh)  # the layers split over pp


def _check_tokens(tokens: torch.Tensor, mesh: Any, microbatches: int = 1) -> "Tuple[int, int]":
    """``(rows, positions)`` of this rank's share of the group's ``[B,
    T]`` tokens: ``B`` splits over the batch axes (and the microbatches),
    ``T`` over ``cp``."""
    b, t = tokens.shape
    _, blocks = _row_block(mesh)
    cp = mesh.axis_size(CP_AXIS)
    if b % (blocks * microbatches) or t % cp:
        raise ValueError(
            f"tokens {tuple(tokens.shape)} do not split over "
            f"{'x'.join(BATCH_AXES)}={blocks} rows"
            + (f" in each of {microbatches} microbatches" if microbatches > 1 else "")
            + f", {CP_AXIS}={cp}")
    return b // blocks, t // cp


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position next-token NLL: logsumexp(logits) - logit[target] ==
    -log_softmax[target] without materializing the [B, T, V]
    log-probability tensor."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    return lse - picked


def _nll_vocab_parallel(
    logits: torch.Tensor, targets: torch.Tensor, tp: MeshAxis
) -> torch.Tensor:
    """:func:`_nll` of logits whose vocabulary is split over ``tp`` (this
    rank's ``V / tp`` columns): the logsumexp from the max over the axis
    and the sum of the exponentials over it, the target's logit from the
    rank that owns it.  The same value on every rank of the axis."""
    if tp.size == 1:
        return _nll(logits, targets)
    vl = logits.shape[-1]
    (maxes,) = tp.all_gather([logits.detach().amax(-1)[None]], [0])
    m = maxes.amax(0)
    total = softmax_math.exp(logits - m[..., None]).sum(-1)
    idx = targets - tp.rank * vl
    own = (idx >= 0) & (idx < vl)
    picked = torch.gather(logits, -1, idx.clamp(0, vl - 1)[..., None])[..., 0]
    total, picked = reduce_from_axis(tp, torch.stack([total, torch.where(own, picked, 0.0)]))
    return m + softmax_math.log(total) - picked


def _row_block(mesh: Any) -> "Tuple[int, int]":
    """``(index, count)`` of this rank's block of batch rows: the rows
    split over ``dp``, ``fsdp`` then ``ep`` (:data:`BATCH_AXES`)."""
    index, count = 0, 1
    for name in BATCH_AXES:
        index = index * mesh.axis_size(name) + mesh.axis_index(name)
        count *= mesh.axis_size(name)
    return index, count


def _chunk_and_targets(
    rows: torch.Tensor, mesh: Any, tl: int
) -> "Tuple[torch.Tensor, torch.Tensor]":
    """This rank's sequence chunk of ``rows`` and its next-token targets,
    which run one position into the next chunk (the last chunk's are one
    shorter)."""
    start = mesh.axis_index(CP_AXIS) * tl
    return rows[:, start:start + tl], rows[:, start + 1:start + tl + 1]


def _shares(mesh: Any) -> int:
    """How many ranks hold a distinct share of the loss outside the
    pipeline: all but the ``tp`` ranks of a row block and chunk, which
    hold the same one."""
    return mesh.size // mesh.axis_size(TP_AXIS)


def loss_fn(
    model: Transformer, tokens: torch.Tensor, mesh: Any = None, microbatches: int = 4,
) -> torch.Tensor:
    """Next-token cross-entropy, mean over all positions but the last.
    MoE configs add the weighted load-balance auxiliary loss.

    With an inner ``mesh``, ``tokens`` is the replica group's whole
    ``[B, T]`` array and the result is this rank's share: its rows
    (``dp`` x ``fsdp`` x ``ep``) and chunk (``cp``), whose targets run one
    position into the next chunk (only the last ``cp`` rank drops the final
    position), summed and divided by the global count ``B * (T - 1)``, plus
    its part of the aux loss.  The ``tp`` ranks of a row block and chunk
    hold the same share; the shares over the other axes sum to the loss.
    A ``pp`` mesh runs the stages in ``microbatches`` (:func:`forward_pipelined`;
    only the last stage's share is not 0)."""
    cfg = model.cfg
    _check_mesh(cfg, mesh)
    if mesh is None or mesh.size == 1:
        logits, aux = model(tokens, return_aux=True, mesh=mesh)
        loss = _nll(logits[:, :-1], tokens[:, 1:]).mean()
        if cfg.n_experts:
            loss = loss + cfg.moe_aux_weight * aux
        return loss
    _check_shards(model, mesh)
    if mesh.axis_size(PP_AXIS) > 1:
        return _pipelined_loss(model, tokens, mesh, microbatches)
    b, t = tokens.shape
    bl, tl = _check_tokens(tokens, mesh)
    block, _ = _row_block(mesh)
    chunk, targets = _chunk_and_targets(tokens[block * bl:(block + 1) * bl], mesh, tl)
    logits, aux = model(chunk, return_aux=True, mesh=mesh)
    nll = _nll_vocab_parallel(logits[:, :targets.shape[1]], targets, mesh.axis(TP_AXIS))
    loss = nll.sum() / (b * (t - 1))
    if cfg.n_experts:
        # every share-holding rank computes the same global aux
        loss = loss + cfg.moe_aux_weight * aux / _shares(mesh)
    return loss


# ---------------------------------------------------------------------------
# pipeline parallelism
# ---------------------------------------------------------------------------


def _pipelined_rows(tokens: torch.Tensor, mesh: Any, microbatches: int) -> torch.Tensor:
    """This rank's rows of the group's tokens under the pipeline: its share
    of each microbatch (microbatch ``m`` is the rows ``[m * B / M, (m + 1)
    * B / M)``, as the JAX package splits the batch, and a rank's share is
    its row block of them), microbatch after microbatch."""
    b, t = tokens.shape
    bl, _ = _check_tokens(tokens, mesh, microbatches)
    block, blocks = _row_block(mesh)
    mbl = bl // microbatches
    return tokens.reshape(microbatches, blocks, mbl, t)[:, block].reshape(bl, t)


def _run_stages(
    model: Transformer, tokens: torch.Tensor, mesh: Any, microbatches: int
) -> "Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]":
    """The GPipe schedule over this rank's rows and chunk ``tokens``:
    ``(x, aux, table)``, the last stage's final activations and per-row
    aux sums (zeros on other stages), and the tied table when the weights
    are sharded (gathered on the first and last stages only)."""
    cfg = model.cfg
    _check_mesh(cfg, mesh)
    _check_shards(model, mesh)
    if cfg.attn_impl not in ("auto", "dense", "flash", "ring", "ulysses"):
        raise ValueError(
            f"forward_pipelined does not support attn_impl {cfg.attn_impl!r}; "
            "expected 'auto', 'dense', 'flash', 'ring' or 'ulysses'")
    pp = mesh.axis(PP_AXIS)
    b, t = tokens.shape
    if b % microbatches:
        raise ValueError(f"batch {b} not divisible by microbatches {microbatches}")
    table = None
    if pp.rank == 0:
        x, table = model._embed(tokens, mesh)
    else:  # only the first stage feeds the pipe
        x = torch.zeros((b, t, cfg.d_model), dtype=cfg.dtype, device=tokens.device)
    if pp.rank == pp.size - 1 and table is None:
        table = model._table(mesh)
    positions = _positions(mesh, t, tokens.device)
    cp = mesh.axis(CP_AXIS)
    moe = bool(cfg.n_experts)

    def layer(h, block):
        y, aux = model._block(block, h["x"] if moe else h, positions, mesh, True)
        if not moe:
            return y
        # each chunk routed on its own: the average over cp is the batch's
        return {"x": y, "aux": h["aux"] + psum(cp, aux) / cp.size}

    mbs = pipeline.split_microbatches(
        {"x": x, "aux": torch.zeros(b, dtype=torch.float32, device=x.device)} if moe else x,
        microbatches)
    out = pipeline.pipeline_stage_outputs(list(model.blocks), mbs, layer, pp)
    if moe:
        return out["x"].reshape(b, t, -1), out["aux"].reshape(b), table
    return out.reshape(b, t, -1), None, table


def forward_pipelined(
    model: Transformer, tokens: torch.Tensor, mesh: Any, microbatches: int = 4,
    return_aux: bool = False,
) -> "torch.Tensor | Tuple[torch.Tensor, torch.Tensor]":
    """Pipeline-parallel forward: the decoder blocks GPipe-scheduled over the
    ``pp`` axis (``parallel/pipeline.py``), the embedding on the first
    stage and the head on every stage on the last stage's outputs (which
    are broadcast over ``pp``).  ``model`` holds this stage's blocks
    (:func:`shard_params`); ``tokens`` is this rank's rows and chunk (row
    ``i`` in microbatch ``i // (B_local / M)``).  Returns this rank's logits
    (its ``V / tp`` columns under tp), the same on every stage; with
    ``return_aux`` also the MoE aux loss, the mean over the group's
    examples of each one's sum over the layers of its microbatch's aux (0
    for a dense FFN).  Gradients reach the blocks through the last stage's
    logits only; the head's parameters, used on every stage, get theirs on
    each."""
    x, aux, _ = _run_stages(model, tokens, mesh, microbatches)
    pp = mesh.axis(PP_AXIS)
    x, aux = pipeline.broadcast_from_last(pp, (x, aux))
    logits = model._head(x, model._table(mesh), mesh.axis(TP_AXIS))
    if not return_aux:
        return logits
    if aux is None:
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)
    total = aux.sum()
    for name in BATCH_AXES:
        total = psum(mesh.axis(name), total)
    return logits, total / (tokens.shape[0] * _row_block(mesh)[1])


def _pipelined_loss(
    model: Transformer, tokens: torch.Tensor, mesh: Any, microbatches: int
) -> torch.Tensor:
    """:func:`loss_fn`'s share under ``pp``: the last stage's rows and
    chunk (head, vocab-parallel NLL, and its rows' aux); on the other
    stages a 0 that starts their backward through the schedule."""
    cfg = model.cfg
    b, t = tokens.shape
    _, tl = _check_tokens(tokens, mesh, microbatches)
    chunk, targets = _chunk_and_targets(_pipelined_rows(tokens, mesh, microbatches), mesh, tl)
    x, aux, table = _run_stages(model, chunk, mesh, microbatches)
    pp = mesh.axis(PP_AXIS)
    if pp.rank < pp.size - 1:
        # the schedule's outputs are zeros here; their gradient is unused
        return x.float().sum() * 0.0
    logits = model._head(x, table, mesh.axis(TP_AXIS))
    nll = _nll_vocab_parallel(logits[:, :targets.shape[1]], targets, mesh.axis(TP_AXIS))
    loss = nll.sum() / (b * (t - 1))
    if aux is not None:
        # the cp ranks of a row hold the same (averaged) aux
        loss = loss + cfg.moe_aux_weight * aux.sum() / (b * mesh.axis_size(CP_AXIS))
    return loss


def make_grad_step(
    cfg: TransformerConfig, mesh: Any = None, microbatches: int = 4,
) -> "Callable[[Transformer, torch.Tensor], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]":
    """A ``(model, tokens) -> (loss, grads)`` step — the FT-DDP shape:
    ``Manager.allreduce`` averages the grads across replica groups, then the
    optimizer steps.  ``grads`` maps parameter names to gradients.

    With an inner ``mesh`` (see :func:`loss_fn`), every rank of the group
    returns the global loss and the gradients of its own parameters (its
    shards), each summed over the batch axes that do not split it, as its
    :func:`param_specs` entry says: ``dp`` and ``cp`` always, ``ep`` for
    all but the experts, ``fsdp`` for the whole leaves (the norms, the
    router; the shards' sum over ``fsdp`` is the weight gather's
    reduce-scatter), ``tp`` never (the column-parallel inputs' gradients
    are summed over it already), ``pp`` for the embedding and the final
    norm only (a stage's blocks are its own).  Ranks holding the same block
    of a leaf get the same bits.  A ``pp`` mesh runs ``microbatches``."""

    def step(
        model: Transformer, tokens: torch.Tensor
    ) -> "Tuple[torch.Tensor, Dict[str, torch.Tensor]]":
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens, mesh, microbatches)
        loss.backward()
        if mesh is None or mesh.size == 1:
            grads = {
                n: p.grad for n, p in model.named_parameters() if p.grad is not None
            }
            return loss.detach(), grads
        grads = {
            n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters()
        }
        specs = param_specs(cfg, mesh)
        loss = loss.detach().clone()
        for axis in mesh.axes.values():
            if axis.size == 1 or axis.name == TP_AXIS:
                continue
            if axis.name == PP_AXIS:
                summed = [g for n, g in grads.items() if _layer_of(n) is None]
            else:
                summed = [g for n, g in grads.items() if axis.name not in specs[n]]
            axis.psum_(summed + [loss])
        return loss, grads

    return step


__all__ = [
    "BATCH_AXES",
    "CP_AXIS",
    "DP_AXIS",
    "EP_AXIS",
    "FSDP_AXIS",
    "MESH_AXES",
    "MOE_LEAVES",
    "PP_AXIS",
    "TP_AXIS",
    "Block",
    "StageBlocks",
    "Transformer",
    "TransformerConfig",
    "forward_pipelined",
    "gather_params",
    "init_params",
    "loss_fn",
    "make_grad_step",
    "param_specs",
    "resolve_device",
    "shard_params",
    "stage_range",
]
