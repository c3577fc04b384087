"""Functionals of the port (counterpart of ``paddle_tpu/nn/functional``)."""
from .activation import gelu
from .attention import _xla_attention
from .common import embedding, linear
from .norm import layer_norm

__all__ = ["gelu", "linear", "embedding", "layer_norm"]
