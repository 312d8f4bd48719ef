"""Small MLP: the DiLoCo example model family.

PyTorch port of ``torchft_tpu/models/mlp.py``.  Each layer is an
``nn.Linear`` registered as ``layer_{i}``: those top-level names are the
DiLoCo fragment boundaries, as the JAX package's top-level param keys are.
The JAX package keeps ``w [in, out]``; ``nn.Linear`` keeps
``weight [out, in]``.
"""

from __future__ import annotations

from typing import List, Mapping, Sequence, Union

import torch
from torch import nn

from torchft_tpu_torch.utils.device import resolve_device


class MLP(nn.Module):
    """``x [B, sizes[0]] -> [B, sizes[-1]]``, ReLU between the layers."""

    def __init__(
        self, sizes: "Sequence[int]", device: "str | torch.device" = "cuda"
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            self.add_module(f"layer_{i}", nn.Linear(n_in, n_out, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = list(self.children())
        for i, layer in enumerate(layers):
            x = layer(x)
            if i < len(layers) - 1:
                x = torch.relu(x)
        return x


def init_params(
    generator: torch.Generator,
    sizes: "Sequence[int]" = (784, 128, 128, 10),
    device: "str | torch.device" = "cuda",
) -> MLP:
    """An :class:`MLP` initialised as the JAX package initialises its
    pytree: weights ~ N(0, 1/fan_in), biases 0.  Values are drawn on the
    CPU from ``generator``, so a seed gives the same weights on every
    device."""
    model = MLP(sizes, device)
    with torch.no_grad():
        for layer in model.children():
            n_out, n_in = layer.weight.shape
            layer.weight.copy_(
                torch.randn((n_in, n_out), generator=generator).t() / n_in**0.5
            )
            layer.bias.zero_()
    return model


def forward(params: MLP, x: torch.Tensor) -> torch.Tensor:
    return params(x)


def fragment_keys(
    params: "Union[nn.Module, Mapping[str, object]]", n_fragments: int
) -> "List[List[str]]":
    """Partition the top-level parameter names (``layer_{i}``, of a module
    or a mapping) into n contiguous fragments (DiLoCo)."""
    names = (
        [n for n, _ in params.named_children()]
        if isinstance(params, nn.Module) else list(params.keys())
    )
    keys = sorted(names, key=lambda k: int(k.rsplit("_", 1)[1]))
    base, rem = divmod(len(keys), n_fragments)
    out, start = [], 0
    for i in range(n_fragments):
        n = base + (1 if i < rem else 0)
        out.append(keys[start : start + n])
        start += n
    return out


__all__ = ["MLP", "forward", "fragment_keys", "init_params"]
