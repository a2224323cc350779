"""The micro-batching HTTP server over the port's batch program."""

from .server import MicroBatcher, Overloaded, StyleTransferService, serve

__all__ = ["MicroBatcher", "Overloaded", "StyleTransferService", "serve"]
