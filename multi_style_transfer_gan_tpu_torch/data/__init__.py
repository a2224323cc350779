"""Host-side input pipeline: file listing, the training folder dataset,
the prefetch to the device, the inpainting mask and the synthetic
two-domain dataset."""

from .dataset import (
    ImageFolderDataset, list_images, prefetch_to_device, random_patch_mask,
)
from .synthetic import monetize, render_photo, write_domains

__all__ = ["ImageFolderDataset", "list_images", "monetize",
           "prefetch_to_device", "random_patch_mask", "render_photo",
           "write_domains"]
