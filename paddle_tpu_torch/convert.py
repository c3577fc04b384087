"""Carry a reference model's weights into the port.

The port keeps the reference's parameter names and shapes (Paddle's
(in, out) Linear layout included), so weights cross as they are, with
numpy as the bridge: ``{name: np.ndarray}`` from the reference's
``named_parameters()``.
"""
import numpy as np
import torch

__all__ = ["reference_state", "load_reference"]


def reference_state(named):
    """``{name: np.ndarray}`` -> ``{name: torch.Tensor}`` (CPU copies)."""
    return {k: torch.from_numpy(np.array(v)) for k, v in named.items()}


@torch.no_grad()
def load_reference(model, named):
    """Copy the reference's ``{name: np.ndarray}`` into ``model``.  The key
    sets and every shape must be exactly equal; any difference raises
    before anything is copied."""
    state = reference_state(named)
    own = dict(model.named_parameters())
    missing, extra = sorted(set(own) - set(state)), \
        sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {extra}")
    bad = [(k, tuple(state[k].shape), tuple(p.shape))
           for k, p in own.items() if tuple(state[k].shape) != tuple(p.shape)]
    if bad:
        raise ValueError(f"parameter shapes differ (name, given, model): "
                         f"{bad}")
    for k, p in own.items():
        p.copy_(state[k])
    return model
