"""Inference pipelines (port of the JAX package's ``pipelines``).

- ``direct``      single image, single style (direct_transform.py)
- ``batch``       the folder throughput path (batch_process_images.py)
- ``advanced``    five named processing variants (advanced_transform.py)
- ``local_style`` region-adaptive segmentation blending
                  (enhanced_local_style.py)
- ``compare``     the enhanced model beside the plain CycleGAN
"""

from .batch import batch_process, make_batch_fn, select_engine
from .direct import test_different_sizes, transform_image, try_skip_connections
from .model_loader import LoadedModel, load_generator, model_from_state_dict

__all__ = ["LoadedModel", "batch_process", "load_generator", "make_batch_fn",
           "model_from_state_dict", "select_engine", "test_different_sizes",
           "transform_image", "try_skip_connections"]
