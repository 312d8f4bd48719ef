"""torchft_tpu_torch — the PyTorch / NVIDIA H100 port of torchft_tpu.

Per-step fault tolerance for data-parallel training: the Manager's quorum
and commit protocol over the shared native coordination core (``native/``),
reconfigurable TCP process groups (in process, or isolated in a worker
subprocess: ``ProcessGroupBabyTCP``), live heal over ``PGTransport`` or
``HTTPTransport``, FT-DDP, LocalSGD/DiLoCo and the optimizer wrapper, the
elastic data samplers, and the flagship transformer, whose attention runs
on hand-written CUDA kernels (``csrc/``).

The root exports what ``torchft_tpu/__init__.py`` exports, under the same
names, plus the port's own extras (the transports, ``module_grads``).

This package imports neither ``jax`` nor ``torchft_tpu``; it keeps its own
copies of the modules it shares with the JAX package.  Entry points run on
the card (``device="cuda"``) unless the caller asks for the CPU.

Telemetry installs from the environment at import, as in the JAX package:
OTLP logs, the OTLP metrics push and traces when ``TORCHFT_USE_OTEL`` is
truthy (traces also with ``TORCHFT_TRACE_FILE``), then the Prometheus
scrape server when ``TORCHFT_METRICS_PORT`` is set.  This import is the
one place the scrape server starts (the Manager does not start one).  A
Baby PG worker imports this package too, so with the env set it installs
its own exporters, as the JAX package's worker does; with
``TORCHFT_METRICS_PORT`` set its scrape server finds the port taken by
its parent's and logs a warning instead.
"""

from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
from torchft_tpu_torch.checkpointing.pg_transport import PGTransport
from torchft_tpu_torch.data import DistributedSampler, StatefulDistributedSampler
from torchft_tpu_torch.ddp import (
    DistributedDataParallel,
    PureDistributedDataParallel,
    module_grads,
)
from torchft_tpu_torch.local_sgd import DiLoCo, LocalSGD
from torchft_tpu_torch.manager import Manager, WorldSizeMode
from torchft_tpu_torch.optim import OptimizerWrapper
from torchft_tpu_torch.parallel.process_group import (
    ErrorSwallowingProcessGroupWrapper,
    ManagedProcessGroup,
    NotParticipatingError,
    ProcessGroup,
    ProcessGroupBabyTCP,
    ProcessGroupDummy,
    ProcessGroupTCP,
)

# Reference name: torchft.Optimizer (torchft/optim.py re-exported at root).
Optimizer = OptimizerWrapper

# Telemetry from env, at import (reference wires its OTEL pipeline at
# import, torchft/__init__.py:20-22 + otel.py:42-86): OTLP logs + metrics
# + traces gated on TORCHFT_USE_OTEL; the Prometheus scrape server gated
# on TORCHFT_METRICS_PORT.
from torchft_tpu_torch.utils.metrics import (  # noqa: E402
    maybe_export_from_env as _metrics_export_install,
    maybe_serve_from_env as _metrics_serve_install,
)
from torchft_tpu_torch.utils.otel import (  # noqa: E402
    maybe_install_from_env as _otel_install,
)
from torchft_tpu_torch.utils.tracing import (  # noqa: E402
    maybe_install_from_env as _traces_install,
)

_otel_install()
_metrics_export_install()
_traces_install()
_metrics_serve_install()
del _otel_install, _metrics_export_install, _traces_install, _metrics_serve_install

__all__ = [
    "DiLoCo",
    "DistributedDataParallel",
    "DistributedSampler",
    "ErrorSwallowingProcessGroupWrapper",
    "HTTPTransport",
    "LocalSGD",
    "ManagedProcessGroup",
    "Manager",
    "NotParticipatingError",
    "Optimizer",
    "OptimizerWrapper",
    "PGTransport",
    "ProcessGroup",
    "ProcessGroupBabyTCP",
    "ProcessGroupDummy",
    "ProcessGroupTCP",
    "PureDistributedDataParallel",
    "StatefulDistributedSampler",
    "WorldSizeMode",
    "module_grads",
]
