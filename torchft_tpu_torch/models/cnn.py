"""Small convnet: the DDP example model family (a CIFAR-10 CNN).

PyTorch port of ``torchft_tpu/models/cnn.py``.  Input is **NHWC**, as the
JAX package takes it.  Convolutions run NCHW with ``[out, in, kh, kw]``
weights (the JAX package keeps ``[kh, kw, in, out]``); the activations are
permuted back to NHWC before the flatten, so ``fc1`` reads its rows in
the JAX package's (H, W, C) order.  "SAME" for 3x3 is ``padding=1``; the
pools are 2x2 with stride 2, VALID.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from torchft_tpu_torch.utils.device import resolve_device


class CNN(nn.Module):
    """``x [B, 32, 32, C]`` NHWC -> logits ``[B, num_classes]``."""

    def __init__(
        self, num_classes: int = 10, channels: int = 3,
        device: "str | torch.device" = "cuda",
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.conv1 = nn.Conv2d(channels, 32, 3, padding=1, device=dev)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1, device=dev)
        self.fc1 = nn.Linear(64 * 8 * 8, 128, device=dev)
        self.fc2 = nn.Linear(128, num_classes, device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.max_pool2d(torch.relu(self.conv1(x)), 2, 2)
        x = F.max_pool2d(torch.relu(self.conv2(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (H, W, C) order
        x = torch.relu(self.fc1(x))
        return self.fc2(x)


def init_params(
    generator: torch.Generator, num_classes: int = 10, channels: int = 3,
    device: "str | torch.device" = "cuda",
) -> CNN:
    """A :class:`CNN` initialised as the JAX package initialises its
    pytree: conv weights ~ N(0, 1/(kh·kw·cin)), ``fc1`` ~ N(0, 1/64^2),
    ``fc2`` ~ N(0, 1/16^2), biases 0; drawn on the CPU from
    ``generator``."""
    model = CNN(num_classes, channels, device)
    with torch.no_grad():
        for conv in (model.conv1, model.conv2):
            cout, cin, kh, kw = conv.weight.shape
            w = torch.randn((kh, kw, cin, cout), generator=generator)
            conv.weight.copy_(w.permute(3, 2, 0, 1) / (kh * kw * cin) ** 0.5)
        for fc, scale in ((model.fc1, 64.0), (model.fc2, 16.0)):
            n_out, n_in = fc.weight.shape
            fc.weight.copy_(torch.randn((n_in, n_out), generator=generator).t() / scale)
        for layer in (model.conv1, model.conv2, model.fc1, model.fc2):
            layer.bias.zero_()
    return model


def forward(params: CNN, x: torch.Tensor) -> torch.Tensor:
    """x [B, 32, 32, C] NHWC -> logits [B, num_classes]."""
    return params(x)


__all__ = ["CNN", "forward", "init_params"]
