"""torchft_tpu_torch — the PyTorch / NVIDIA H100 port of torchft_tpu.

Per-step fault tolerance for data-parallel training: the Manager's quorum
and commit protocol over the shared native coordination core (``native/``),
a reconfigurable TCP process group, live heal over ``PGTransport``, FT-DDP
and the optimizer wrapper, and the flagship transformer, whose attention
runs on hand-written CUDA kernels (``csrc/``).

This package imports neither ``jax`` nor ``torchft_tpu``; it keeps its own
copies of the modules it shares with the JAX package.  Entry points run on
the card (``device="cuda"``) unless the caller asks for the CPU.
"""

from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
from torchft_tpu_torch.checkpointing.pg_transport import PGTransport
from torchft_tpu_torch.ddp import DistributedDataParallel, module_grads
from torchft_tpu_torch.manager import Manager, WorldSizeMode
from torchft_tpu_torch.optim import OptimizerWrapper
from torchft_tpu_torch.parallel.process_group import (
    ErrorSwallowingProcessGroupWrapper,
    ManagedProcessGroup,
    ProcessGroup,
    ProcessGroupDummy,
    ProcessGroupTCP,
)

__all__ = [
    "DistributedDataParallel",
    "ErrorSwallowingProcessGroupWrapper",
    "HTTPTransport",
    "ManagedProcessGroup",
    "Manager",
    "OptimizerWrapper",
    "PGTransport",
    "ProcessGroup",
    "ProcessGroupDummy",
    "ProcessGroupTCP",
    "WorldSizeMode",
    "module_grads",
]
