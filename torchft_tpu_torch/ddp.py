"""Fault-tolerant data parallelism for PyTorch training loops.

PyTorch port of ``torchft_tpu/ddp.py`` (reference: torchft/ddp.py:32-105).
Gradients are gathered from the module into a ``{parameter name: grad}``
dict and averaged in one fused ``Manager.allreduce``: zero-contribution
participation and live-count division come from the Manager (reference
trick, manager.py:416-417).  The averaged gradients come back on the device
each gradient lives on.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.parallel.work import Work
from torchft_tpu_torch.utils.pytree import tree_flatten, tree_unflatten


def module_grads(module: nn.Module) -> "Dict[str, torch.Tensor]":
    """``{name: p.grad}`` for every parameter of ``module`` that has one."""
    return {
        name: p.grad
        for name, p in module.named_parameters()
        if p.grad is not None
    }


class DistributedDataParallel:
    """FT gradient averaging over the elastic replica dimension.

    Usage::

        ddp = DistributedDataParallel(manager)
        loss.backward()
        avg_grads = ddp.allreduce_gradients(module_grads(model)).wait()
    """

    def __init__(self, manager: Manager, should_quantize: bool = False) -> None:
        self._manager = manager
        self._should_quantize = should_quantize

    def allreduce_gradients(self, grads: Any) -> Work:
        """Average a gradient pytree (a dict from parameter name to
        gradient) over the live quorum in one fused op."""
        return self._manager.allreduce(grads, should_quantize=self._should_quantize)


class PureDistributedDataParallel:
    """Naive per-leaf allreduce (reference ddp.py:82-105; the JAX package's
    ``ddp.py:54-64``): one ``Manager.allreduce`` per gradient, over a
    ``{name: grad}`` dict (:func:`module_grads`) or any pytree of tensors.
    Simpler to reason about, one collective per parameter — for tests and
    small models.  Returns the averaged gradients in the same structure,
    each on its own device."""

    def __init__(self, manager: Manager) -> None:
        self._manager = manager

    def allreduce_gradients(self, grads: Any) -> Any:
        leaves, treedef = tree_flatten(grads)
        works = [self._manager.allreduce(leaf) for leaf in leaves]
        return tree_unflatten(treedef, [w.wait() for w in works])
