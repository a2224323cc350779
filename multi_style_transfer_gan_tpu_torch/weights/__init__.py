"""Checkpoint import, conversion and inspection."""

from .torch_import import (
    convert_model, detect_channels, detect_model_kind,
    discriminator_state_dict_from_jax, extract_state_dict, load_pth, pth_info,
    save_pth, state_dict_from_jax_params, vgg16_state_dict_from_jax,
)

__all__ = ["convert_model", "detect_channels", "detect_model_kind",
           "discriminator_state_dict_from_jax", "extract_state_dict",
           "load_pth", "pth_info", "save_pth", "state_dict_from_jax_params",
           "vgg16_state_dict_from_jax"]
