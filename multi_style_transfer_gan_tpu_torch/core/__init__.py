"""Core building blocks with PyTorch-compatible numerics.

``core/conv.py`` has no counterpart: ``nn.Conv2d`` and ``nn.ConvTranspose2d``
carry the semantics that the JAX file re-derives.
"""

from .activations import gelu
from .norm import InstanceNorm, in_relu, instance_norm, l2_normalize

__all__ = ["InstanceNorm", "gelu", "in_relu", "instance_norm", "l2_normalize"]
