"""Image helpers, the classical-CV toolbox (``color``, ``filters``,
``clahe``, ``smooth``, ``segmentation``) and the hand-written kernels
(``ops.kernels``)."""

from .image import (
    aspect_crop_bounds, from_model_range, resize, resize_center_crop,
    restore_aspect, to_model_range,
)

__all__ = ["aspect_crop_bounds", "from_model_range", "resize",
           "resize_center_crop", "restore_aspect", "to_model_range"]
