"""Discriminator replay buffer (port of ``train/pool.py``), the CycleGAN
paper's image pool, behind ``--pool_size``; 0 keeps the reference's
behaviour of scoring the current fakes only.

Per-image law, as the JAX ``pool_sample``: while the pool is not full the
fake is inserted and passed through; once full, with p = 0.5 the fake passes
through (pool untouched), else a uniform random entry is returned and the
fake takes its place. The images live on the device; the two draws per
image come from an explicit CPU ``torch.Generator``, so sampling needs no
device round trip. Unlike the JAX function, which returns a new pool, the
port writes the pool in place (and returns it).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class ImagePool:
    images: torch.Tensor   # (pool_size, H, W, 3), model-range values
    n: int                 # filled count


def pool_init(pool_size: int, image_size: int, dtype=torch.float32,
              device="cpu") -> ImagePool:
    """An empty pool; ``dtype`` is the step's compute type."""
    if pool_size <= 0:
        raise ValueError("pool_size must be positive; a zero-capacity pool "
                         "means 'no pool': pass pools=None instead")
    return ImagePool(torch.zeros(pool_size, image_size, image_size, 3,
                                 dtype=dtype, device=device), 0)


def pool_sample(pool: ImagePool, fakes: torch.Tensor,
                generator: torch.Generator):
    """Push each fake of the (B, H, W, 3) batch through the pool law, in
    batch order. Returns ``(pool, d_batch)``, d_batch shaped like fakes."""
    size = pool.images.shape[0]
    out = []
    for img in fakes.to(pool.images.dtype):
        use_hist = bool(torch.rand((), generator=generator) < 0.5)
        idx = int(torch.randint(0, size, (), generator=generator))
        if pool.n < size:
            pool.images[pool.n] = img
            pool.n += 1
            out.append(img)
        elif use_hist:
            out.append(pool.images[idx].clone())
            pool.images[idx] = img
        else:
            out.append(img)
    return pool, torch.stack(out)
