"""Device resolution for the port's entry points.

They run on the card unless the caller asks for the CPU: with no CUDA
device present, ``resolve_device(None)`` raises instead of carrying on
on the CPU.
"""
import torch

__all__ = ["resolve_device", "module_device"]


def resolve_device(device=None):
    """``None`` -> the current CUDA device, or ``RuntimeError`` when there
    is none; anything else -> that ``torch.device`` (a CUDA one only if a
    CUDA device is present).  A CUDA device always carries its index."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; pass device='cpu' to run on "
                "the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def module_device(module):
    """The device of a module's parameters (they all share one)."""
    return next(module.parameters()).device
