"""Inference pipelines: the checkpoint loader and the batch program."""

from .batch import batch_process, make_batch_fn, select_engine
from .model_loader import LoadedModel, load_generator

__all__ = ["LoadedModel", "batch_process", "load_generator", "make_batch_fn",
           "select_engine"]
