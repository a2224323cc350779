"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every wrapper dispatches on the device of the tensor it is given: a CPU
tensor runs the plain version, a CUDA tensor launches the kernel or raises.
Each wrapper carries ``launches``, a plain integer it increments once per
kernel launch and nowhere else.
"""

from .fused_transformer import fused_structural_block, structural_block_plain
from .window_attention import (
    window_channel_attention, window_channel_attention_plain,
)

KERNELS = (window_channel_attention, fused_structural_block)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "KERNELS", "fused_structural_block", "reset_launch_counts",
    "structural_block_plain", "window_channel_attention",
    "window_channel_attention_plain",
]
