"""Serving of the port (counterpart of ``paddle_tpu/inference``)."""
from .scheduler import FCFSScheduler, Request
from .serving import ServingEngine

__all__ = ["ServingEngine", "Request", "FCFSScheduler"]
