"""Host side of the input pipeline, and the inpainting mask (port of
``data/dataset.py``).

``ImageFolderDataset`` decodes the reference's ``{split}{domain}`` folders
(monet2photo layout) to uint8 on the host; ``prefetch_to_device`` moves the
batches to the card ahead of use. The model transform (``to_model_range``)
runs on the card inside the train step, so only uint8 crosses PCIe.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np
import torch

_EXTS = ("jpg", "jpeg", "png", "bmp")


def list_images(directory, exts: Sequence[str] = _EXTS) -> list[str]:
    """Images in ``directory`` with any of ``exts`` in lower or upper case,
    sorted (the reference's batch_process_images.py:469-473)."""
    files: list[str] = []
    for ext in exts:
        for e in (ext, ext.upper()):
            files.extend(glob.glob(os.path.join(str(directory), f"*.{e}")))
    return sorted(set(files))


class ImageFolderDataset:
    """``root/{split}{domain}/*.{jpg,png}``; yields uint8 HWC images,
    shorter side resized to ``host_size`` (LANCZOS) and center-cropped to
    ``img_size`` so batches stack."""

    def __init__(self, root, domain: str, split: str = "train",
                 img_size: int = 256, host_size: int | None = None):
        self.root = Path(root)
        self.domain = domain
        self.split = split
        self.img_size = img_size
        self.host_size = host_size
        self.image_paths = list_images(self.root / f"{split}{domain}",
                                       ("jpg", "png"))

    def __len__(self):
        return len(self.image_paths)

    def load(self, idx: int) -> np.ndarray:
        from PIL import Image

        img = Image.open(self.image_paths[idx]).convert("RGB")
        if self.host_size:
            w, h = img.size
            s = self.host_size / min(w, h)
            img = img.resize((max(1, round(w * s)), max(1, round(h * s))),
                             Image.LANCZOS)
        return np.asarray(img, np.uint8)

    def batches(self, batch_size: int, *, shuffle: bool = True,
                seed: int = 42, drop_last: bool = True,
                epochs: int | None = None, process_index: int = 0,
                process_count: int = 1) -> Iterator[np.ndarray]:
        """Stacked uint8 batches of (img_size, img_size, 3) images, shuffled
        per epoch by a numpy generator seeded with ``seed`` (the JAX
        package's order).

        ``batch_size`` is the GLOBAL batch. Under data parallelism each
        rank passes its ``process_index`` and the ``process_count``: every
        rank shuffles alike, and each decodes only its strided slice
        ``idxs[process_index::process_count]`` of every global batch, as
        the JAX package's hosts do (data/dataset.py:84-110)."""
        if batch_size % max(process_count, 1):
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"process count {process_count}")
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.arange(len(self))
            if shuffle:
                rng.shuffle(order)
            for i in range(0, len(order), batch_size):
                idxs = order[i:i + batch_size]
                if drop_last and len(idxs) < batch_size:
                    continue
                yield np.stack([self._square(self.load(j)) for j in
                                idxs[process_index::process_count]])
            epoch += 1

    def _square(self, img: np.ndarray) -> np.ndarray:
        """Center-crop to (img_size, img_size), edge-padding a tiny source."""
        if self.host_size is None:
            return img
        h, w = img.shape[:2]
        s = self.img_size
        top, left = max(0, (h - s) // 2), max(0, (w - s) // 2)
        out = img[top:top + s, left:left + s]
        if out.shape[:2] != (s, s):
            out = np.pad(out, ((0, s - out.shape[0]), (0, s - out.shape[1]),
                               (0, 0)), mode="edge")
        return out


def random_patch_mask(batch_size: int, img_size: int = 256, grid: int = 8,
                      p: float = 0.4, width: int | None = None, *,
                      generator: torch.Generator | None = None,
                      device) -> torch.Tensor:
    """The reference's inpainting mask (pretrain.py:47-56), batched
    (data/dataset.py:131-150): a (B, img_size, width or img_size, 1) float
    mask on ``device``, 1 = keep, 0 = a dropped patch, each cell of the
    ``grid`` x ``grid`` grid dropped i.i.d. with probability ``p``. The
    draws come from ``generator`` (a CPU ``torch.Generator``; None: torch's
    default one), and only the (B, grid, grid) cells cross to the device."""
    w = width if width is not None else img_size
    if img_size % grid or w % grid:
        raise ValueError(f"mask size {img_size}x{w} not divisible by the "
                         f"{grid}x{grid} patch grid")
    keep = (torch.rand((batch_size, grid, grid), generator=generator)
            < 1.0 - p).float().to(device)
    mask = keep.repeat_interleave(img_size // grid, dim=1)
    return mask.repeat_interleave(w // grid, dim=2)[..., None]


def prefetch_to_device(iterator, device, buffer_size: int = 2):
    """Yield the items of ``iterator`` (numpy arrays, or tuples of them) as
    tensors on ``device``. A worker thread decodes ahead and puts each batch
    in pinned host memory when the device is CUDA, so the copy can overlap
    compute; an error in the worker is raised in the consumer."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def host(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if pin else t

    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    end = object()

    def worker():
        try:
            for item in iterator:
                q.put(tuple(map(host, item)) if isinstance(item, tuple)
                      else host(item))
            q.put(end)
        except BaseException as e:  # handed to the consumer, not swallowed
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        if isinstance(item, tuple):
            yield tuple(t.to(device, non_blocking=pin) for t in item)
        else:
            yield item.to(device, non_blocking=pin)
