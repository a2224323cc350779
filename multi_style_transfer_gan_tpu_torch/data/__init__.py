"""Host-side file listing (the part of the JAX ``data`` package the
batch pipeline needs)."""

from __future__ import annotations

import glob
import os
from typing import Sequence

_EXTS = ("jpg", "jpeg", "png", "bmp")


def list_images(directory, exts: Sequence[str] = _EXTS) -> list[str]:
    """Images in ``directory`` with any of ``exts`` in lower or upper case,
    sorted (the reference's batch_process_images.py:469-473)."""
    files: list[str] = []
    for ext in exts:
        for e in (ext, ext.upper()):
            files.extend(glob.glob(os.path.join(str(directory), f"*.{e}")))
    return sorted(set(files))


__all__ = ["list_images"]
