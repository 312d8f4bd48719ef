from torchft_tpu_torch.utils.faults import (
    FAULTS,
    FaultRegistry,
    FaultRule,
    InjectedConnectionDrop,
    InjectedFault,
)
from torchft_tpu_torch.utils.futures import (
    context_timeout,
    future_timeout,
    future_wait,
)
from torchft_tpu_torch.utils.logging import ReplicaLogger, log_event, recent_events
from torchft_tpu_torch.utils.metrics import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsHTTPServer,
    counter,
    gauge,
    histogram,
    parse_text_exposition,
)
from torchft_tpu_torch.utils.retry import RetryPolicy
from torchft_tpu_torch.utils.rwlock import RWLock

__all__ = [
    "Counter",
    "FAULTS",
    "FaultRegistry",
    "FaultRule",
    "Gauge",
    "Histogram",
    "InjectedConnectionDrop",
    "InjectedFault",
    "MetricsHTTPServer",
    "REGISTRY",
    "RWLock",
    "RetryPolicy",
    "context_timeout",
    "counter",
    "future_timeout",
    "future_wait",
    "gauge",
    "histogram",
    "log_event",
    "parse_text_exposition",
    "recent_events",
    "ReplicaLogger",
]
