"""Move transformer weights between the JAX package's pytree and the port.

The JAX package keeps per-layer weights stacked on a leading ``[n_layers]``
axis (``blocks.wq`` is ``[L, d_model, out]``, applied as ``h @ W``) and ties
the output head to ``embed``.  The port keeps one :class:`Block` per layer
with ``nn.Linear`` weights ``[out, in]``, so each matrix is transposed on
the way in and out.  A MoE block's leaves (``router [L, d, E]``,
``w_gate``/``w_up [L, E, d, f]``, ``w_down [L, E, f, d]``) keep the JAX
layout in the port, so they move as they are.  Both directions go through
numpy.

Sharded weights (fsdp, tp, ep; pp by layer): ``params_from_jax(...,
mesh=...)`` gives a rank the blocks of the JAX pytree that JAX's
``shard_params`` gives the device at the same place of the same mesh (under
``pp``, of its stage's layers only), and :func:`gather_to_jax` puts every
rank's blocks back together into the whole pytree.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from torchft_tpu_torch.models.transformer import (
    MOE_LEAVES,
    Transformer,
    TransformerConfig,
    param_specs,
    shard_params,
)

#: stacked JAX block leaves that are matrices (transposed to [out, in])
_ATTN = ("wq", "wk", "wv", "wo")
_FFN = ("w_gate", "w_up", "w_down")
_NORMS = ("attn_norm", "mlp_norm")


def _layout(cfg: TransformerConfig) -> "tuple":
    """``(matrices, as-is leaves)`` of a block: the dense FFN's matrices
    are transposed, a MoE block's leaves are not."""
    if cfg.n_experts:
        return _ATTN, _NORMS + MOE_LEAVES
    return _ATTN + _FFN, _NORMS


def params_from_jax(
    tree: "Mapping[str, Any]",
    cfg: TransformerConfig,
    device: "str | torch.device" = "cuda",
    mesh: Any = None,
) -> Transformer:
    """A :class:`Transformer` holding the weights of the JAX pytree ``tree``
    (numpy arrays, as ``jax.tree_util.tree_map(np.asarray, params)``); with
    an inner ``mesh``, only this rank's shards of them
    (:func:`~torchft_tpu_torch.models.transformer.shard_params`)."""
    model = Transformer(cfg, device)

    def put(param: torch.Tensor, value: Any) -> None:
        param.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))

    with torch.no_grad():
        put(model.embed, tree["embed"])
        put(model.final_norm, tree["final_norm"])
        blocks = tree["blocks"]
        matrices, as_is = _layout(cfg)
        for layer, block in enumerate(model.blocks):
            for name in as_is:
                put(getattr(block, name), blocks[name][layer])
            for name in matrices:
                put(getattr(block, name).weight, np.asarray(blocks[name][layer]).T)
    if mesh is not None:
        shard_params(model, mesh)
    return model


def params_to_jax(
    named: "Mapping[str, torch.Tensor] | Transformer", cfg: TransformerConfig
) -> "Dict[str, Any]":
    """The JAX pytree layout (numpy f32) of the port's parameters — or of
    anything keyed by their names, such as the gradients of a grad step."""
    if isinstance(named, torch.nn.Module):
        named = dict(named.named_parameters())

    def get(name: str) -> np.ndarray:
        return named[name].detach().float().cpu().numpy()

    blocks: Dict[str, Any] = {}
    matrices, as_is = _layout(cfg)
    for name in as_is:
        blocks[name] = np.stack(
            [get(f"blocks.{l}.{name}") for l in range(cfg.n_layers)]
        )
    for name in matrices:
        blocks[name] = np.stack(
            [get(f"blocks.{l}.{name}.weight").T for l in range(cfg.n_layers)]
        )
    return {
        "embed": get("embed"),
        "blocks": blocks,
        "final_norm": get("final_norm"),
    }


def gather_to_jax(
    shards: "Sequence[Mapping[str, torch.Tensor] | Transformer]",
    cfg: TransformerConfig,
    mesh_shape: "Mapping[str, int]",
) -> "Dict[str, Any]":
    """The whole JAX pytree (numpy f32) from every rank's shards, in rank
    order over the inner mesh ``mesh_shape`` (row-major, as
    ``ft_init_device_mesh`` lays the ranks out): each rank's parameters, or
    anything keyed by their names, such as its gradients.  A leaf comes
    from the ranks that hold it (under ``pp``, its stage's)."""
    names = list(mesh_shape)
    sizes = tuple(int(n) for n in mesh_shape.values())
    if len(shards) != int(np.prod(sizes, dtype=np.int64)):
        raise ValueError(f"{len(shards)} ranks for the mesh {dict(mesh_shape)}")
    shards = [dict(s.named_parameters()) if isinstance(s, torch.nn.Module) else s
              for s in shards]
    whole: Dict[str, np.ndarray] = {}
    for name, spec in param_specs(cfg, mesh_shape).items():
        holders = [r for r, named in enumerate(shards) if name in named]
        if not holders:
            raise ValueError(f"no rank holds {name}")
        first = shards[holders[0]][name].detach().float().cpu().numpy()
        full = np.empty(
            [n * (mesh_shape[a] if a else 1) for n, a in zip(first.shape, spec)],
            np.float32)
        for rank in holders:
            named = shards[rank]
            coords = dict(zip(names, np.unravel_index(rank, sizes)))
            index = tuple(
                slice(None) if a is None else
                slice(int(coords[a]) * n, (int(coords[a]) + 1) * n)
                for n, a in zip(first.shape, spec))
            full[index] = named[name].detach().float().cpu().numpy()
        whole[name] = full
    return params_to_jax({n: torch.from_numpy(a) for n, a in whole.items()}, cfg)
