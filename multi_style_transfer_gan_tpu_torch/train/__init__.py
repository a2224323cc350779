"""Training: CycleGAN (losses, the train step, the image pool, full-state
checkpoints), masked-inpainting pretraining, and the VGG16 perceptual +
Gram loss for the train step's ``extra_g_loss`` hook (``train.perceptual``)
(port of the JAX package's ``train``)."""

from .checkpoint import latest_step, restore_train_state, save_train_state
from .cyclegan import (
    CycleGANState, cyclegan_init_state, cyclegan_train_step, make_optimizers,
    save_models,
)
from .losses import l1_loss, lsgan_loss, masked_l1, mse_loss
from .pool import ImagePool, pool_init, pool_sample, pool_sample_global
from .pretrain import (
    PretrainState, learning_rate, pretrain_init_state,
    pretrain_train_step, restore_pretrain_state, save_pretrain_checkpoint,
)

__all__ = [
    "CycleGANState", "ImagePool", "PretrainState",
    "cyclegan_init_state", "cyclegan_train_step", "l1_loss", "latest_step",
    "learning_rate", "lsgan_loss", "make_optimizers", "masked_l1",
    "mse_loss", "pool_init", "pool_sample", "pool_sample_global",
    "pretrain_init_state",
    "pretrain_train_step", "restore_pretrain_state", "restore_train_state",
    "save_models", "save_pretrain_checkpoint", "save_train_state",
]
