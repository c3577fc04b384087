"""Quantized-weight matmul dispatch (counterpart of
``paddle_tpu/ops/quant_dispatch.py``).

- :class:`QuantizedWeight`: the narrow weight ``q`` with its fp32
  per-channel ``scale``;
- :func:`quantize_weight`: the one-time per-output-channel absmax pass
  (int8; fp8 is not ported yet and raises);
- :func:`quant_matmul`: ``x @ dequant(qw)`` through the ``int8_matmul``
  kernel, with the activation scale taken as one global absmax over every
  row of ``x`` (the reference's dynamic per-call scale);
- :func:`dequant_rows`: rows of a tied vocab table from its transposed
  quantized form (the input-embedding gather).
"""
import torch

from .cuda.quant_matmul import int8_matmul

__all__ = ["QuantizedWeight", "quantize_weight", "quant_matmul",
           "dequant_rows", "QUANT_MODES"]

_I8_BND = 127.0
QUANT_MODES = ("int8", "fp8")


def _bnd(ref):
    # a tensor divisor: on CUDA a Python-number divisor becomes a multiply
    # by its reciprocal, one rounding away from the reference's division
    return torch.tensor(_I8_BND, dtype=torch.float32, device=ref.device)


class QuantizedWeight:
    """A quantized linear weight: narrow values + per-channel scale.

    ``q``: (K, N) int8, contiguous; ``scale``: (N,) fp32, the channel
    absmax, so that ``w ~= q * scale / 127`` (the ``int8_matmul`` w_scale
    convention).  ``orig_dtype`` is the torch dtype before quantization,
    which dequantized rows return to.
    """

    __slots__ = ("q", "scale", "mode", "orig_dtype")

    def __init__(self, q, scale, mode, orig_dtype):
        self.q = q
        self.scale = scale
        self.mode = mode
        self.orig_dtype = orig_dtype

    def __repr__(self):
        return (f"QuantizedWeight(mode={self.mode!r}, "
                f"shape={tuple(self.q.shape)}, orig={self.orig_dtype})")


def quantize_weight(w, mode):
    """One-time per-output-channel absmax quantization of a (K, N) weight
    (a transposed view is fine: ``q`` comes out contiguous)."""
    if mode not in QUANT_MODES:
        raise ValueError(f"quantize_weight: mode must be one of "
                         f"{QUANT_MODES}, got {mode!r}")
    if mode == "fp8":
        raise NotImplementedError("fp8 weight quantization is not ported "
                                  "yet; use mode='int8'")
    wf = w.float()
    amax = torch.clamp_min(wf.abs().amax(dim=0), 1e-12)
    # 127 / amax first, then the multiply, as the reference orders it
    q = torch.clamp(torch.round(wf * (_bnd(wf) / amax)), -_I8_BND, _I8_BND)
    return QuantizedWeight(q.to(torch.int8).contiguous(), amax.contiguous(),
                           "int8", w.dtype)


def dequant_rows(qw, ids):
    """Rows of the ORIGINAL (V, H) vocab table from its transposed (H, V)
    quantized form: ``ids`` (...,) int -> (..., H) in ``qw.orig_dtype``."""
    cols = qw.q[:, ids]                                   # (H, ...)
    g = torch.movedim(cols, 0, -1).float()                # (..., H)
    s = qw.scale[ids][..., None].float()
    return (g * (s / _bnd(s))).to(qw.orig_dtype)


def quant_matmul(x, qw, out_dtype=None):
    """``x @ dequant(qw)``: ``x`` (..., K) float, ``qw`` an int8
    :class:`QuantizedWeight`.  Returns (..., N) in ``out_dtype`` (default
    ``x.dtype``)."""
    if qw.mode != "int8":
        raise NotImplementedError(f"quant_matmul: mode {qw.mode!r} is not "
                                  "ported yet")
    if out_dtype is None:
        out_dtype = x.dtype
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k).contiguous()
    # one global absmax over every row (inactive serving slots included),
    # floored at 1e-6 — a reduction outside the kernel, as in the reference
    act_scale = torch.clamp_min(x2.abs().amax().float(), 1e-6)
    out2 = int8_matmul(x2, qw.q, qw.scale, act_scale, out_dtype)
    return out2.reshape(*lead, qw.q.shape[1])
