"""Runtime helpers the CLIs need."""

from .runtime import MetricsLogger, throughput_meter

__all__ = ["MetricsLogger", "throughput_meter"]
