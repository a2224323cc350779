"""Checkpoint import."""

from .torch_import import (
    detect_channels, detect_model_kind, discriminator_state_dict_from_jax,
    extract_state_dict, load_pth, state_dict_from_jax_params,
)

__all__ = ["detect_channels", "detect_model_kind",
           "discriminator_state_dict_from_jax", "extract_state_dict",
           "load_pth", "state_dict_from_jax_params"]
