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
implicitly in the JAX package).  MoE and ``remat_policy="dots"`` under an
inner mesh are not ported yet (ROADMAP §A 3(c)).

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

Rematerialization: ``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``).  ``remat_policy="full"`` keeps only the block
inputs; ``"dots"`` is the JAX package's ``dots_saveable``: selective
activation checkpointing keeps every matmul's output (``aten.mm``,
``addmm``, ``bmm``) and kernel A's (the flash forward op) and recomputes
only the elementwise work between them.

Not ported yet: expert parallelism and the pipeline.
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

from torchft_tpu_torch.models.moe import MoEConfig, moe_ffn_stats
from torchft_tpu_torch.ops import softmax_math
from torchft_tpu_torch.ops.flash_attention import flash_attention, flash_fwd_op
from torchft_tpu_torch.ops.ring_attention import (
    dense_attention,
    ring_attention,
)
from torchft_tpu_torch.ops.ulysses import ulysses_attention
from torchft_tpu_torch.parallel.axis import (
    MeshAxis,
    copy_to_axis,
    gather_shards,
    reduce_from_axis,
)
from torchft_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

#: the inner mesh's axis names: batch, sequence, and the two that shard
#: weights
DP_AXIS = "dp"
CP_AXIS = "cp"
FSDP_AXIS = "fsdp"
TP_AXIS = "tp"
#: the axes the batch rows split over, in the JAX package's order
#: (``_batch_axes``: the row block is ``dp_index * fsdp + fsdp_index``)
BATCH_AXES = (DP_AXIS, FSDP_AXIS)


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
#: kernel A (``jax.checkpoint_policies.dots_saveable`` keeps dot outputs)
_DOT_OPS = frozenset({
    torch.ops.aten.mm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default,
    torch.ops.aten.baddbmm.default,
    flash_fwd_op._opoverload,
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
    row-parallel ones ``(fsdp, tp)``, the norms whole.  With a ``mesh``
    (an inner mesh or a mesh shape), axes it does not name are dropped,
    and a mesh with neither ``fsdp`` nor ``tp`` is warned about once, as
    the JAX package does (weights then stay whole on every rank)."""
    if cfg.n_experts:
        raise NotImplementedError(
            "MoE under an inner mesh (moe_param_specs) is not ported yet "
            "(ROADMAP §A 3(c))")
    specs: "Dict[str, Tuple[Optional[str], ...]]" = {"embed": (TP_AXIS, FSDP_AXIS)}
    for layer in range(cfg.n_layers):
        specs[f"blocks.{layer}.attn_norm"] = (None,)
        for name, spec in _BLOCK_SPECS.items():
            if name == "w_gate":
                specs[f"blocks.{layer}.mlp_norm"] = (None,)
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
    over the inner ``mesh``), in place; returns ``model``.  Every rank
    starts from the same whole weights (one seed), as ``jax.device_put``
    of one array to a ``NamedSharding`` does."""
    cfg = model.cfg
    if tuple(model.embed.shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"model is already sharded (embed {tuple(model.embed.shape)})")
    specs = param_specs(cfg, mesh)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = _local_block(p.data, specs[name], mesh).clone()
    return model


def gather_params(
    named: "Mapping[str, torch.Tensor]", cfg: TransformerConfig, mesh: Any,
    keep: bool = True,
) -> "Dict[str, torch.Tensor]":
    """The inverse of :func:`shard_params`, collective: each of this rank's
    shards in ``named`` (its parameters, or anything keyed by their names,
    such as its gradients) made whole by gathering it over the axes its
    :func:`param_specs` entry splits it on, leaf by leaf.  Every rank of
    the group calls it; with ``keep=False`` a rank takes part in the
    gathers but holds none of the whole tensors (and returns ``{}``)."""
    specs = param_specs(cfg, mesh)
    out = {}
    for name, t in named.items():
        whole = t.detach()
        for dim, axis in enumerate(specs[name]):
            if axis is not None and mesh.axis_size(axis) > 1:
                (whole,) = mesh.axis(axis).all_gather([whole.contiguous()], [dim])
        if keep:
            out[name] = whole
    return out


def _axis(mesh: Any, name: str) -> MeshAxis:
    return mesh.axis(name) if mesh is not None else MeshAxis(name, None, 0, 1)


def _check_shards(model: "Transformer", mesh: Any) -> None:
    cfg = model.cfg
    want = (cfg.vocab_size // mesh.axis_size(TP_AXIS),
            cfg.d_model // mesh.axis_size(FSDP_AXIS))
    if tuple(model.embed.shape) != want:
        raise ValueError(
            f"parameters are not sharded for {mesh!r} (embed "
            f"{tuple(model.embed.shape)}, expected {want}): call "
            "shard_params(model, mesh)")


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
        self, x: torch.Tensor, positions: torch.Tensor, mesh: Any = None
    ) -> "Tuple[torch.Tensor, torch.Tensor]":
        """``mesh`` is the inner mesh ring/Ulysses attention runs over and
        the weights are sharded over; ``x`` is then this rank's rows and
        chunk, ``positions`` global."""
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
            y, aux, dropped = moe_ffn_stats(h, params, self.moe_cfg)
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
        columns."""
        cfg = self.cfg
        if cfg.remat and cfg.remat_policy not in ("full", "dots"):
            raise ValueError(
                f"unknown remat_policy {cfg.remat_policy!r}; expected 'full' or 'dots'"
            )
        _check_mesh(cfg, mesh)
        kw = {"context_fn": _dots_context} if cfg.remat_policy == "dots" else {}
        b, t = tokens.shape
        fsdp, tp = _axis(mesh, FSDP_AXIS), _axis(mesh, TP_AXIS)
        table = None
        if fsdp.size > 1 or tp.size > 1:
            _check_shards(self, mesh)
            # the tied table, whole over fsdp, in the compute dtype's values
            (table,) = gather_shards(fsdp, [self.embed], [1], [cfg.dtype])
            table = table.float()
            x = _embed_local(table, tokens, tp).to(cfg.dtype)
        else:
            # _embed: a gather of the activation-dtype table (same values
            # as casting the table first)
            x = self.embed[tokens].to(cfg.dtype)
        offset = mesh.axis_index(CP_AXIS) * t if mesh is not None else 0
        positions = offset + torch.arange(t, device=tokens.device)
        aux_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for block in self.blocks:
            if cfg.remat and self.training:
                x, aux = checkpoint(
                    block, x, positions, mesh, use_reentrant=False, **kw
                )
            else:
                x, aux = block(x, positions, mesh)
            aux_sum = aux_sum + aux
        logits = self._head(x, table, tp)
        if return_aux:
            return logits, aux_sum
        return logits

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


def _check_mesh(cfg: TransformerConfig, mesh: Any) -> None:
    """What the port runs under an inner mesh so far: ``dp``, ``fsdp``,
    ``tp`` and ``cp`` axes, a dense FFN, and ``remat_policy="dots"`` only
    without ``cp`` (ROADMAP §A 3(c) for ``pp``, ``ep`` and the rest)."""
    if mesh is None or mesh.size == 1:
        return
    known = 1
    for name in (DP_AXIS, FSDP_AXIS, TP_AXIS, CP_AXIS):
        known *= mesh.axis_size(name)
    if known != mesh.size:
        raise NotImplementedError(
            f"inner mesh {mesh!r}: only the {DP_AXIS!r}, {FSDP_AXIS!r}, "
            f"{TP_AXIS!r} and {CP_AXIS!r} axes are ported; the pipeline (pp) "
            "and expert parallelism (ep) follow (ROADMAP §A 3(c))"
        )
    if cfg.n_experts:
        raise NotImplementedError(
            "MoE under an inner mesh needs the global routing statistics "
            "(ROADMAP §A 3(c))"
        )
    if cfg.remat and cfg.remat_policy == "dots" and _cp_size(mesh) > 1:
        raise NotImplementedError(
            "remat_policy='dots' under context parallelism (ROADMAP §A 3(c)); "
            "use 'full' or remat=False"
        )
    tp = mesh.axis_size(TP_AXIS)
    if cfg.n_heads % tp:
        raise ValueError(f"{cfg.n_heads} query heads do not split over {TP_AXIS}={tp}")


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
    split over ``dp`` then ``fsdp`` (:data:`BATCH_AXES`)."""
    index, count = 0, 1
    for name in BATCH_AXES:
        index = index * mesh.axis_size(name) + mesh.axis_index(name)
        count *= mesh.axis_size(name)
    return index, count


def loss_fn(
    model: Transformer, tokens: torch.Tensor, mesh: Any = None
) -> torch.Tensor:
    """Next-token cross-entropy, mean over all positions but the last.
    MoE configs add the weighted load-balance auxiliary loss.

    With an inner ``mesh``, ``tokens`` is the replica group's whole
    ``[B, T]`` array and the result is this rank's share: its rows
    (``dp`` x ``fsdp``) and chunk (``cp``), whose targets run one position
    into the next chunk (only the last ``cp`` rank drops the final
    position), summed and divided by the global count ``B * (T - 1)``.
    The ``tp`` ranks of a row block and chunk hold the same share; the
    shares over the other axes sum to the loss."""
    _check_mesh(model.cfg, mesh)
    if mesh is None or mesh.size == 1:
        logits, aux = model(tokens, return_aux=True, mesh=mesh)
        loss = _nll(logits[:, :-1], tokens[:, 1:]).mean()
        if model.cfg.n_experts:
            loss = loss + model.cfg.moe_aux_weight * aux
        return loss
    if mesh.axis_size(FSDP_AXIS) > 1 or mesh.axis_size(TP_AXIS) > 1:
        _check_shards(model, mesh)
    b, t = tokens.shape
    block, blocks = _row_block(mesh)
    cp = mesh.axis_size(CP_AXIS)
    if b % blocks or t % cp:
        raise ValueError(
            f"tokens {tuple(tokens.shape)} do not split over "
            f"{'x'.join(BATCH_AXES)}={blocks} rows, {CP_AXIS}={cp}")
    bl, tl = b // blocks, t // cp
    rows = tokens[block * bl:(block + 1) * bl]
    start = mesh.axis_index(CP_AXIS) * tl
    chunk = rows[:, start:start + tl]
    targets = rows[:, start + 1:start + tl + 1]
    logits = model(chunk, mesh=mesh)
    nll = _nll_vocab_parallel(logits[:, :targets.shape[1]], targets, mesh.axis(TP_AXIS))
    return nll.sum() / (b * (t - 1))


def make_grad_step(
    cfg: TransformerConfig, mesh: Any = None
) -> "Callable[[Transformer, torch.Tensor], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]":
    """A ``(model, tokens) -> (loss, grads)`` step — the FT-DDP shape:
    ``Manager.allreduce`` averages the grads across replica groups, then the
    optimizer steps.  ``grads`` maps parameter names to gradients.

    With an inner ``mesh`` (see :func:`loss_fn`), every rank of the group
    returns the global loss and the gradients of its own parameters (its
    shards), each summed over the batch axes that do not split it, as its
    :func:`param_specs` entry says: ``dp`` and ``cp`` always, ``fsdp`` for
    the whole leaves (the norms; the shards' sum over ``fsdp`` is the
    weight gather's reduce-scatter), ``tp`` never (the column-parallel
    inputs' gradients are summed over it already).  Ranks holding the same
    block of a leaf get the same bits."""

    def step(
        model: Transformer, tokens: torch.Tensor
    ) -> "Tuple[torch.Tensor, Dict[str, torch.Tensor]]":
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens, mesh)
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
            axis.psum_([g for n, g in grads.items() if axis.name not in specs[n]] + [loss])
        return loss, grads

    return step


__all__ = [
    "BATCH_AXES",
    "CP_AXIS",
    "DP_AXIS",
    "FSDP_AXIS",
    "MOE_LEAVES",
    "TP_AXIS",
    "Block",
    "Transformer",
    "TransformerConfig",
    "gather_params",
    "init_params",
    "loss_fn",
    "make_grad_step",
    "param_specs",
    "resolve_device",
    "shard_params",
]
