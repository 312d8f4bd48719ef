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

Rematerialization: ``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``).  ``remat_policy="full"`` keeps only the block
inputs; ``"dots"`` is the JAX package's ``dots_saveable``: selective
activation checkpointing keeps every matmul's output (``aten.mm``,
``addmm``, ``bmm``) and kernel A's (the flash forward op) and recomputes
only the elementwise work between them.

Not ported yet: weight sharding (fsdp, tp, expert parallelism) and the
pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from torchft_tpu_torch.models.moe import MoEConfig, moe_ffn_stats
from torchft_tpu_torch.ops.flash_attention import flash_attention, flash_fwd_op
from torchft_tpu_torch.ops.ring_attention import (
    dense_attention,
    ring_attention,
)
from torchft_tpu_torch.ops.ulysses import ulysses_attention
from torchft_tpu_torch.utils.device import resolve_device


#: the inner mesh's axis names for the batch and the sequence
DP_AXIS = "dp"
CP_AXIS = "cp"


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

    def forward(
        self, x: torch.Tensor, positions: torch.Tensor, mesh: Any = None
    ) -> "Tuple[torch.Tensor, torch.Tensor]":
        """``mesh`` is the inner mesh ring/Ulysses attention runs over;
        ``x`` is then this rank's chunk and ``positions`` global."""
        cfg = self.cfg
        act = cfg.dtype
        b, t, _ = x.shape
        nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        h = _rms_norm(x, self.attn_norm)
        q = F.linear(h, self.wq.weight.to(act)).reshape(b, t, nh, hd)
        k = F.linear(h, self.wk.weight.to(act)).reshape(b, t, nkv, hd)
        v = F.linear(h, self.wv.weight.to(act)).reshape(b, t, nkv, hd)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        attn = self._attention(q, k, v, mesh).reshape(b, t, nh * hd)
        x = x + F.linear(attn, self.wo.weight.to(act))
        h = _rms_norm(x, self.mlp_norm)
        if cfg.n_experts:
            params = {n: getattr(self, n) for n in MOE_LEAVES}
            y, aux, dropped = moe_ffn_stats(h, params, self.moe_cfg)
            self.moe_stats = {"aux": aux.detach(), "dropped": dropped}
            return x + y, aux
        gate = F.silu(F.linear(h, self.w_gate.weight.to(act)))
        up = F.linear(h, self.w_up.weight.to(act))
        x = x + F.linear(gate * up, self.w_down.weight.to(act))
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
        loss (0 for a dense FFN).  With an inner ``mesh`` whose ``cp`` axis
        is larger than 1, ``tokens`` is this rank's sequence chunk: rotary
        positions start at ``cp_rank * T_local`` and attention runs over
        the axis."""
        cfg = self.cfg
        if cfg.remat and cfg.remat_policy not in ("full", "dots"):
            raise ValueError(
                f"unknown remat_policy {cfg.remat_policy!r}; expected 'full' or 'dots'"
            )
        _check_mesh(cfg, mesh)
        kw = {"context_fn": _dots_context} if cfg.remat_policy == "dots" else {}
        b, t = tokens.shape
        # _embed: a gather of the activation-dtype table (same values as
        # casting the table first)
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
        logits = self._head(x)
        if return_aux:
            return logits, aux_sum
        return logits

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + tied output head with f32 logits.

        The JAX package multiplies in the activation dtype with f32
        accumulation (``preferred_element_type=float32``).  A bf16
        ``torch.matmul`` would round the logits to bf16, so both operands
        are rounded to the activation dtype and then multiplied in f32: a
        product of two bf16 values is exact in f32, so this is the same
        bf16-input, f32-accumulate product (TF32 must stay off, as it is by
        default)."""
        act = self.cfg.dtype
        x = _rms_norm(x, self.final_norm)
        return torch.matmul(x.to(act).float(), self.embed.to(act).float().t())


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
    """What the port runs under an inner mesh so far: ``dp`` and ``cp``
    axes, a dense FFN, full or no remat (ROADMAP §A 3(c) for the rest)."""
    if mesh is None or mesh.size == 1:
        return
    known = mesh.axis_size(DP_AXIS) * mesh.axis_size(CP_AXIS)
    if known != mesh.size:
        raise NotImplementedError(
            f"inner mesh {mesh!r}: only the {DP_AXIS!r} and "
            f"{CP_AXIS!r} axes are ported (ROADMAP §A 3(c))"
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


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position next-token NLL: logsumexp(logits) - logit[target] ==
    -log_softmax[target] without materializing the [B, T, V]
    log-probability tensor."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    return lse - picked


def loss_fn(
    model: Transformer, tokens: torch.Tensor, mesh: Any = None
) -> torch.Tensor:
    """Next-token cross-entropy, mean over all positions but the last.
    MoE configs add the weighted load-balance auxiliary loss.

    With an inner ``mesh``, ``tokens`` is the replica group's whole
    ``[B, T]`` array and the result is this rank's share: its rows
    (``dp``) and chunk (``cp``), whose targets run one position into the
    next chunk (only the last ``cp`` rank drops the final position),
    summed and divided by the global count ``B * (T - 1)``.  The shares
    over the mesh sum to the loss."""
    _check_mesh(model.cfg, mesh)
    if mesh is None or mesh.size == 1:
        logits, aux = model(tokens, return_aux=True, mesh=mesh)
        loss = _nll(logits[:, :-1], tokens[:, 1:]).mean()
        if model.cfg.n_experts:
            loss = loss + model.cfg.moe_aux_weight * aux
        return loss
    cfg = model.cfg
    b, t = tokens.shape
    dp, cp = mesh.axis_size(DP_AXIS), mesh.axis_size(CP_AXIS)
    if b % dp or t % cp:
        raise ValueError(f"tokens {tuple(tokens.shape)} do not split over dp={dp}, cp={cp}")
    bl, tl = b // dp, t // cp
    first = mesh.axis_index(DP_AXIS) * bl
    rows = tokens[first:first + bl]
    start = mesh.axis_index(CP_AXIS) * tl
    chunk = rows[:, start:start + tl]
    targets = rows[:, start + 1:start + tl + 1]
    logits = model(chunk, mesh=mesh)
    return _nll(logits[:, :targets.shape[1]], targets).sum() / (b * (t - 1))


def make_grad_step(
    cfg: TransformerConfig, mesh: Any = None
) -> "Callable[[Transformer, torch.Tensor], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]":
    """A ``(model, tokens) -> (loss, grads)`` step — the FT-DDP shape:
    ``Manager.allreduce`` averages the grads across replica groups, then the
    optimizer steps.  ``grads`` maps parameter names to gradients.

    With an inner ``mesh`` (see :func:`loss_fn`), every rank of the group
    returns the global loss and the gradients summed over the mesh's axes,
    the same bits on every rank."""

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
        mesh.psum_(list(grads.values()))
        return mesh.psum(loss), grads

    return step


__all__ = [
    "MOE_LEAVES",
    "Block",
    "Transformer",
    "TransformerConfig",
    "init_params",
    "loss_fn",
    "make_grad_step",
    "resolve_device",
]
