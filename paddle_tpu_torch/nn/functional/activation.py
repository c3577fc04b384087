"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``)."""
import math

import torch

__all__ = ["gelu"]

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form, in the order
    ``jax.nn.gelu`` computes it."""
    if approximate:
        cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI
                                      * (x + 0.044715 * (x ** 3))))
        return x * cdf
    return x * (torch.erf(x / math.sqrt(2.0)) + 1) / 2
