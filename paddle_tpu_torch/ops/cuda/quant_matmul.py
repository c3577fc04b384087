"""Int8 matmul with the activation quantize and the dequant epilogue fused
into one hand-written Hopper kernel (``csrc/quant_matmul.cu``).

Replaces the TPU kernel ``paddle_tpu/ops/pallas/quant_matmul.py:40``
(``_qmm_kernel``, launched by ``int8_matmul:59``) and computes the same
function::

    xq  = clip(round(x / act_scale * 127), -128, 127)      (half to even)
    out = (xq @ w_int) * ((act_scale / 127) * (w_scale / 127))

What bounds it on an H100, and what the design does about it, is written
at the top of the CUDA source: at the serving shapes it is bound by the
bytes of the int8 weight it streams.

:func:`int8_matmul` launches the kernel for CUDA tensors and takes the
plain version :func:`int8_matmul_plain` only for tensors on the CPU.  On
the card the two agree bit for bit: the plain version quantizes the same
way, sums the integer products in float64 (exact here: the sum stays
below 2^53) and applies the same epilogue in the same order.
"""
import ctypes

import torch

from . import _build

__all__ = ["int8_matmul", "int8_matmul_plain"]

_BND = 127.0
_DTYPES = (torch.float32, torch.bfloat16)


def _bnd(ref):
    # a tensor on ref's device: on CUDA, dividing by a Python number
    # becomes a multiply by its reciprocal, which may differ in the last
    # bit from the kernel's true division
    return torch.tensor(_BND, dtype=torch.float32, device=ref.device)


def int8_matmul_plain(x, w_int, w_scale, act_scale, out_dtype):
    """The plain PyTorch version of :func:`int8_matmul` (same arguments)."""
    bnd = _bnd(x)
    xq = torch.clamp(torch.round(x.float() / act_scale * bnd), -_BND - 1,
                     _BND)
    acc = (xq.double() @ w_int.double()).float()
    scale = (act_scale / bnd) * (w_scale.float() / bnd)
    return (acc * scale).to(out_dtype)


def _library():
    lib = _build.load("quant_matmul")
    fn = lib.int8_matmul_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(x, w_int, w_scale, act_scale, out_dtype):
    if x.dim() != 2 or w_int.dim() != 2 or w_scale.dim() != 1 \
            or act_scale.dim() != 0:
        raise ValueError("int8_matmul takes x (M, K), w_int (K, N), "
                         "w_scale (N,) and a 0-d act_scale")
    M, K = x.shape
    if M < 1 or K < 1 or tuple(w_int.shape)[0] != K \
            or tuple(w_scale.shape) != (w_int.shape[1],) \
            or w_int.shape[1] < 1:
        raise ValueError(f"int8_matmul shapes do not match: x "
                         f"{tuple(x.shape)}, w_int {tuple(w_int.shape)}, "
                         f"w_scale {tuple(w_scale.shape)}")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"int8_matmul takes float32 or bfloat16 x and "
                        f"out_dtype, got {x.dtype} and {out_dtype}")
    if w_int.dtype != torch.int8 or w_scale.dtype != torch.float32 \
            or act_scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul takes int8 w_int and float32 scales, "
                        f"got {w_int.dtype}, {w_scale.dtype}, "
                        f"{act_scale.dtype}")
    for name, t in (("x", x), ("w_int", w_int), ("w_scale", w_scale),
                    ("act_scale", act_scale)):
        if t.device != x.device:
            raise ValueError(f"int8_matmul: {name} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous")


def int8_matmul(x, w_int, w_scale, act_scale, out_dtype):
    """``x`` (M, K) float32/bfloat16, ``w_int`` (K, N) int8 row-major,
    ``w_scale`` (N,) float32, ``act_scale`` a 0-d float32 tensor (read by
    the kernel through its pointer: no host sync).  Returns (M, N) in
    ``out_dtype``.

    A CUDA tensor launches the kernel (and counts the launch in
    ``int8_matmul.launches``) or raises; a CPU tensor takes the plain
    version."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_int, w_scale, act_scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on CUDA or the CPU, not "
                         f"{x.device}")
    _check(x, w_int, w_scale, act_scale, out_dtype)
    M, K = x.shape
    N = w_int.shape[1]
    fn = _library()
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                w_int.data_ptr(), w_scale.data_ptr(), act_scale.data_ptr(),
                out.data_ptr(), int(out_dtype == torch.bfloat16), M, K, N,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul launch failed: CUDA error {rc}")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
