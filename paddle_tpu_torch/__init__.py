"""PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper.

Mirrors the reference package's module paths, public names and
parameter names; every TPU kernel on a ported path becomes a kernel
written by hand for ``sm_90a`` (``csrc/``, bound in ``ops/cuda``).
Imports torch and numpy, never JAX and nothing of ``paddle_tpu``.
"""
import torch

from .device import resolve_device

__all__ = ["resolve_device", "seed"]


def seed(value):
    """``paddle.seed`` counterpart: seed torch's default generators (the
    CPU's and every CUDA device's); returns the CPU generator."""
    return torch.manual_seed(value)
