"""Host-side input pipeline: file listing, the training folder dataset and
the prefetch to the device."""

from .dataset import ImageFolderDataset, list_images, prefetch_to_device

__all__ = ["ImageFolderDataset", "list_images", "prefetch_to_device"]
