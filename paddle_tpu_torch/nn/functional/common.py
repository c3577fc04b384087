"""Common functionals: linear and embedding (counterpart of
``paddle_tpu/nn/functional/common.py``)."""
import torch

from ...ops.quant_dispatch import QuantizedWeight, dequant_rows, quant_matmul

__all__ = ["linear", "embedding"]


def linear(x, weight, bias=None):
    """Paddle layout: ``weight`` is (in_features, out_features).  A
    :class:`QuantizedWeight` (swapped in by the serving quantization pass)
    goes through :func:`quant_matmul`; a float weight is a plain matmul."""
    if isinstance(weight, QuantizedWeight):
        out = quant_matmul(x, weight, out_dtype=x.dtype)
        return out + bias.to(out.dtype) if bias is not None else out
    out = torch.matmul(x, weight)
    return out + bias if bias is not None else out


def embedding(x, weight, padding_idx=None):
    """Rows of ``weight`` at ids ``x``.  A :class:`QuantizedWeight` is a
    tied vocab table stored transposed: only the touched rows are
    dequantized."""
    if isinstance(weight, QuantizedWeight):
        out = dequant_rows(weight, x)
    else:
        out = weight[x]
    if padding_idx is not None:
        out = out * (x != padding_idx)[..., None].to(out.dtype)
    return out
