"""Runtime helpers the CLIs need."""

from .runtime import MetricsLogger

__all__ = ["MetricsLogger"]
