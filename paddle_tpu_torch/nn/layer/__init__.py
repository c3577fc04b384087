"""Layers of the port (counterpart of ``paddle_tpu/nn/layer``)."""
from .common import Embedding, Linear
from .norm import LayerNorm

__all__ = ["Linear", "Embedding", "LayerNorm"]
