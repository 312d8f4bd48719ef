from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
from torchft_tpu_torch.checkpointing.pg_transport import PGTransport
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport

__all__ = ["CheckpointTransport", "HTTPTransport", "PGTransport"]
