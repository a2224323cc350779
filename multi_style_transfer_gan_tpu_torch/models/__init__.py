"""The EnhancedGenerator and its parts as ``nn.Module``s with the
reference checkpoints' ``state_dict()`` keys."""

from .enhanced_generator import (
    EnhancedGenerator, LocalAttention, MultiScaleBlock, channels_of,
    num_transformer_blocks_of,
)
from .structural_transformer import (
    StructuralTransformerBlock, default_num_heads,
)

__all__ = [
    "EnhancedGenerator", "LocalAttention", "MultiScaleBlock",
    "StructuralTransformerBlock", "channels_of", "default_num_heads",
    "num_transformer_blocks_of",
]
