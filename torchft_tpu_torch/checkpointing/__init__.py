from torchft_tpu_torch.checkpointing.durable import (
    latest_checkpoint,
    list_checkpoints,
    load_checkpoint,
    save_checkpoint,
)
from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
from torchft_tpu_torch.checkpointing.pg_transport import PGTransport
from torchft_tpu_torch.checkpointing.store import (
    FragmentStore,
    StoreSpiller,
    select_cut,
    store_from_env,
)
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport

__all__ = [
    "CheckpointTransport",
    "FragmentStore",
    "HTTPTransport",
    "PGTransport",
    "StoreSpiller",
    "latest_checkpoint",
    "list_checkpoints",
    "load_checkpoint",
    "save_checkpoint",
    "select_cut",
    "store_from_env",
]
