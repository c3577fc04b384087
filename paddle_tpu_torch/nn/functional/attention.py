"""Attention (counterpart of ``paddle_tpu/nn/functional/attention.py``).

Only ``_xla_attention`` is ported.  On the serving path the reference
never reaches a flash kernel: cached attention has keys of the buffer's
length, so its dispatch answers "cross-seq" (``attention.py:109``) and
runs this math, on a TPU too.
"""
import math

import torch

__all__ = ["_xla_attention"]


def _xla_attention(q, k, v, mask=None, causal=False, scale=None):
    """(B, S, H, D) attention with the reference's operation order: fp32
    scores, scale ``1/sqrt(D)``, additive mask, fp32 softmax, ``p`` cast
    to ``v.dtype``, then the second product."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None]
        ki = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, -1e30)
    if mask is not None:
        s = s + mask.to(s.dtype)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return o.to(q.dtype)
