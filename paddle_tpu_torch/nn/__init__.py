"""``nn`` of the port (counterpart of ``paddle_tpu/nn``)."""
from . import functional
from .layer import Embedding, LayerNorm, Linear

__all__ = ["functional", "Linear", "Embedding", "LayerNorm"]
