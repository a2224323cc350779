"""The EnhancedGenerator, its parts, the plain encoder-decoder Generator and
the EnhancedDiscriminator as ``nn.Module``s with the reference checkpoints'
``state_dict()`` keys."""

from .discriminator import EnhancedDiscriminator, SNConv2d
from .enhanced_generator import (
    EnhancedGenerator, LocalAttention, MultiScaleBlock, channels_of,
    num_transformer_blocks_of,
)
from .init_utils import kaiming_conv, torch_default_conv, torch_default_linear
from .plain_generator import PlainGenerator
from .packed_generator import (
    PackedEnhancedGenerator, pack_enhanced_generator_params,
    packed_enhanced_generator_apply,
)
from .quantized_generator import (
    QuantizedEnhancedGenerator, prepare_int8_model,
)
from .structural_transformer import (
    StructuralTransformerBlock, default_num_heads,
)

__all__ = [
    "EnhancedDiscriminator", "EnhancedGenerator", "LocalAttention",
    "MultiScaleBlock", "PackedEnhancedGenerator", "PlainGenerator",
    "QuantizedEnhancedGenerator", "SNConv2d",
    "StructuralTransformerBlock", "channels_of", "default_num_heads",
    "kaiming_conv", "num_transformer_blocks_of", "pack_enhanced_generator_params",
    "packed_enhanced_generator_apply", "prepare_int8_model",
    "torch_default_conv",
    "torch_default_linear",
]
