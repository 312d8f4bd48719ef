"""The exponential and logarithm of the attention paths' softmax.

Kernels A-C compute ``e^x`` as ``exp2f(x * log2(e))``; the plain PyTorch
twins, the ring's plain tile body and the ring's f32 merge do the same
with ``torch.exp2``, and take ``ln x`` as ``xlogy(1, x)``.

Why not ``torch.exp``/``torch.log``: on a CPU float tensor they call MKL's
vector math library (VML), and the first VML call of a process that has
already run an MKL matmul, made from two or more OpenMP threads under CPU
load, has returned one thread's share of the tensor about 1e-4 (relative)
off, while every later call agreed to the bit (exp: 8 of 90 fresh
processes at 2 threads beside two busy 8-thread matmul loops; tanh, log
and log2 likewise; none with ``MKL_CBWR=COMPATIBLE``).  ATen computes
``exp2`` and ``xlogy`` with its own code: 0 of the same 90 processes,
where each ran before the first ``torch.exp``.  ``2^(x * log2 e)`` lies
within 3e-7 (relative) of ``e^x`` for ``x > -5`` and within 6e-8 absolute
for all ``x <= 0``.
"""

from __future__ import annotations

import torch

#: log2(e): e^x = 2^(x * log2 e)
LOG2E = 1.4426950408889634


def exp(x: torch.Tensor) -> torch.Tensor:
    """``e^x`` as ``2^(x * log2 e)``."""
    return torch.exp2(x * LOG2E)


def log(x: torch.Tensor) -> torch.Tensor:
    """``ln x`` as ``xlogy(1, x)``."""
    return torch.xlogy(1.0, x)


__all__ = ["LOG2E", "exp", "log"]
