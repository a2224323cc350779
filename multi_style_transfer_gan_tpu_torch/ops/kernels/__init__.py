"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every wrapper dispatches on the device of the tensor it is given: a CPU
tensor runs the plain version, a CUDA tensor launches the kernel or raises.
Each wrapper carries ``launches``, a plain integer it increments once per
kernel launch and nowhere else. The inference kernels are forward-only and
raise on a CUDA call that autograd would record; the training kernels come
in forward/backward pairs behind one ``torch.autograd.Function`` each.
``window_channel_attention_fast_vjp`` is the JAX package's route for the
LocalAttention widths no training kernel takes (every C but 1, 2, 4, 8,
16, 32, 64; ``train_route``): the inference kernel forward, the
backward recomputed through the plain version. ``int8_conv`` is the int8
serving engine's convolution (``models/quantized_generator.py``).
"""

from .fused_transformer import fused_structural_block, structural_block_plain
from .int8_conv import int8_conv, int8_conv_plain
from .packed_window_attention import (
    packed_window_channel_attention, packed_window_channel_attention_plain,
)
from .window_attention import (
    STAGES, window_channel_attention, window_channel_attention_plain,
    window_channel_attention_stage, window_channel_attention_stage_plain,
)
from .window_attention_fast_vjp import (
    train_route, window_channel_attention_fast_vjp,
)
from .window_attention_train import (
    window_attention_mid_backward_plain, window_attention_mid_bwd,
    window_attention_mid_fwd, window_attention_mid_plain,
    window_channel_attention_train,
)
from .window_mhsa_train import (
    window_mhsa_backward_plain, window_mhsa_bwd, window_mhsa_fwd,
    window_mhsa_plain, window_mhsa_train,
)
from .window_relayout import (
    depth_to_space_plain, space_to_depth_plain, window_relayout,
)

KERNELS = (window_channel_attention, fused_structural_block,
           packed_window_channel_attention, window_relayout,
           window_attention_mid_fwd, window_attention_mid_bwd,
           window_mhsa_fwd, window_mhsa_bwd, window_channel_attention_stage,
           int8_conv)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "KERNELS", "STAGES", "depth_to_space_plain",
    "fused_structural_block", "int8_conv", "int8_conv_plain",
    "packed_window_channel_attention", "packed_window_channel_attention_plain",
    "reset_launch_counts", "space_to_depth_plain", "structural_block_plain",
    "train_route", "window_attention_mid_backward_plain",
    "window_attention_mid_bwd", "window_attention_mid_fwd",
    "window_attention_mid_plain", "window_channel_attention",
    "window_channel_attention_fast_vjp", "window_channel_attention_plain",
    "window_channel_attention_stage",
    "window_channel_attention_stage_plain", "window_channel_attention_train",
    "window_mhsa_backward_plain", "window_mhsa_bwd", "window_mhsa_fwd",
    "window_mhsa_plain", "window_mhsa_train", "window_relayout",
]
