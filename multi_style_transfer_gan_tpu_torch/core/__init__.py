"""Core building blocks with PyTorch-compatible numerics."""

from .activations import gelu, leaky_relu
from .conv import conv, linear
from .norm import (
    InstanceNorm, batch_norm, in_leaky_relu, in_relu, instance_norm, l2_normalize,
    spectral_normalize,
)

__all__ = ["InstanceNorm", "batch_norm", "conv", "gelu", "in_leaky_relu", "in_relu",
           "instance_norm", "l2_normalize", "leaky_relu", "linear",
           "spectral_normalize"]
