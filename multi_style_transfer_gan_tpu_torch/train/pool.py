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

Under data parallelism the law runs over the GLOBAL batch in order, as the
JAX step's replicated pool does (train/pool.py:50-56): every rank gathers
the fakes, runs the same draws from a generator in the same state and
keeps the same pool, and takes its own block of the result
(:func:`pool_sample_global`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..parallel import mesh


@dataclass
class ImagePool:
    images: torch.Tensor   # (pool_size, H, W, 3), model-range values
    n: int                 # filled count


def pool_init(pool_size: int, image_size: int, dtype=torch.float32, *,
              device) -> ImagePool:
    """An empty pool on ``device``; ``dtype`` is the step's compute type."""
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


def pool_sample_global(pool: ImagePool, fakes: torch.Tensor,
                       generator: torch.Generator):
    """:func:`pool_sample` over the global batch: ``fakes`` is this rank's
    block; the blocks of every rank are gathered in rank order, the law
    runs on the whole global batch (``generator`` in the same state on
    every rank, so the pools stay identical), and this rank's block of the
    result is returned beside the pool. Without a process group it is
    ``pool_sample`` itself."""
    if not mesh.active():
        return pool_sample(pool, fakes, generator)
    pool, out = pool_sample(pool, mesh.all_gather_batch(fakes), generator)
    return pool, mesh.rank_block(out)
