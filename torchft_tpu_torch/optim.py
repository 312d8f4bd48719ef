"""Fault-tolerant optimizer wrapper (torch.optim).

PyTorch port of ``torchft_tpu/optim.py`` (reference: torchft/optim.py:48-55):
the step boundary hooks the FT protocol — ``begin_step`` (``zero_grad``)
starts the quorum; ``step`` writes the averaged gradients into ``.grad``
and steps the wrapped optimizer only if ``should_commit`` votes yes.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from torchft_tpu_torch.manager import Manager


class OptimizerWrapper:
    """Wraps a ``torch.optim.Optimizer`` with the Manager protocol.

    Usage::

        opt = OptimizerWrapper(manager, torch.optim.AdamW(model.parameters()))
        opt.zero_grad()                        # starts quorum
        loss.backward()
        avg = ddp.allreduce_gradients(module_grads(model)).wait()
        committed = opt.step(model, avg)
    """

    def __init__(self, manager: Manager, optimizer: torch.optim.Optimizer) -> None:
        self._manager = manager
        self.optimizer = optimizer

    def begin_step(self) -> None:
        """Start the new step's quorum (reference: zero_grad -> start_quorum)
        and clear the gradients."""
        self._manager.start_quorum()
        self.optimizer.zero_grad(set_to_none=True)

    zero_grad = begin_step

    def step(
        self,
        module: "Optional[nn.Module]" = None,
        grads: "Optional[Dict[str, torch.Tensor]]" = None,
    ) -> bool:
        """Apply the update iff the group votes to commit; returns whether
        it committed.  ``grads`` (averaged, by parameter name of
        ``module``) replace the local ``.grad`` first.  On a failed commit
        nothing changes, so the step is retried on consistent state."""
        if not self._manager.should_commit():
            return False
        if grads is not None:
            if module is None:
                raise ValueError("grads need the module they belong to")
            params = dict(module.named_parameters())
            with torch.no_grad():
                for name, g in grads.items():
                    p = params[name]
                    if p.grad is None:
                        p.grad = g.to(p.device, p.dtype).clone()
                    else:
                        p.grad.copy_(g)
        self.optimizer.step()
        return True
