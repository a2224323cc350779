"""CycleGAN training: losses, the train step, the image pool and full-state
checkpoints (port of the JAX package's ``train``; masked-inpainting
pretraining and the perceptual loss are not ported)."""

from .checkpoint import latest_step, restore_train_state, save_train_state
from .cyclegan import (
    CycleGANState, cyclegan_init_state, cyclegan_train_step, make_optimizers,
    save_models,
)
from .losses import l1_loss, lsgan_loss, mse_loss
from .pool import ImagePool, pool_init, pool_sample

__all__ = [
    "CycleGANState", "ImagePool", "cyclegan_init_state",
    "cyclegan_train_step", "l1_loss", "latest_step", "lsgan_loss",
    "make_optimizers", "mse_loss", "pool_init", "pool_sample",
    "restore_train_state", "save_models", "save_train_state",
]
