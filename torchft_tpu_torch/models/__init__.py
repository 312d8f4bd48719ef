"""Model families: the flagship llama-style transformer (dense or MoE FFN)
and the example-scale CNN and MLP."""

from torchft_tpu_torch.models import cnn, mlp, moe, transformer
from torchft_tpu_torch.models.moe import MoEConfig, moe_ffn
from torchft_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    init_params,
    loss_fn,
    make_grad_step,
)

__all__ = [
    "cnn",
    "mlp",
    "moe",
    "transformer",
    "MoEConfig",
    "Transformer",
    "TransformerConfig",
    "init_params",
    "loss_fn",
    "make_grad_step",
    "moe_ffn",
]
