"""The port's hand-written CUDA kernels on the card, against their plain
versions, bit for bit.  Imports neither JAX nor the JAX package, so that it
runs on a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Without a CUDA device every case skips (decided inside the fixture).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import quant_dispatch as qd
from paddle_tpu_torch.ops.cuda.quant_matmul import (int8_matmul,
                                                    int8_matmul_plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _mk(M, K, N, seed, dev, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(M, K).astype("f4")).to(dev, dtype)
    w_int = torch.from_numpy(
        rng.randint(-127, 128, (K, N)).astype(np.int8)).to(dev)
    w_scale = torch.from_numpy((0.5 + rng.rand(N)).astype("f4")).to(dev)
    a_s = torch.clamp_min(x.abs().amax().float(), 1e-6)
    return x, w_int, w_scale, a_s


# ragged in every dimension: M off the 16/64-row tiles, K off the 64-deep
# step and the 8-element runs, N off the 16-byte weight runs
@pytest.mark.parametrize("M,K,N", [(1, 8, 16), (5, 100, 200), (16, 64, 8),
                                   (17, 72, 1000), (37, 129, 33),
                                   (70, 3072, 768), (256, 768, 50304)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_equals_plain_bitwise(cuda, M, K, N, dtype):
    x, w_int, w_scale, a_s = _mk(M, K, N, M + K + N, cuda, dtype)
    for out_dtype in (dtype, torch.float32):
        out = int8_matmul(x, w_int, w_scale, a_s, out_dtype)
        ref = int8_matmul_plain(x, w_int, w_scale, a_s, out_dtype)
        torch.cuda.synchronize()
        assert out.dtype == out_dtype and out.shape == (M, N)
        assert torch.equal(out, ref)


def test_unaligned_rows_take_the_element_path(cuda):
    """x starting 4 bytes into its storage: no 16-byte loads are legal."""
    x, w_int, w_scale, a_s = _mk(9, 65, 48, 3, cuda)
    xs = torch.empty(9 * 65 + 1, device=cuda)[1:].view(9, 65)
    xs.copy_(x)
    out = int8_matmul(xs, w_int, w_scale, a_s, torch.float32)
    assert torch.equal(out, int8_matmul_plain(x, w_int, w_scale, a_s,
                                              torch.float32))


def test_launches_are_counted(cuda):
    x, w_int, w_scale, a_s = _mk(8, 64, 64, 1, cuda)
    before = int8_matmul.launches
    int8_matmul(x, w_int, w_scale, a_s, torch.float32)
    assert int8_matmul.launches == before + 1
    int8_matmul_plain(x, w_int, w_scale, a_s, torch.float32)
    assert int8_matmul.launches == before + 1


def test_quant_matmul_on_card_equals_cpu(cuda):
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(3, 5, 96).astype("f4"))
    w = torch.from_numpy(rng.randn(96, 80).astype("f4"))
    out = qd.quant_matmul(x.to(cuda), qd.quantize_weight(w.to(cuda), "int8"))
    ref = qd.quant_matmul(x, qd.quantize_weight(w, "int8"))
    assert torch.equal(out.cpu(), ref)


def test_wrapper_rejects_bad_inputs(cuda):
    x, w_int, w_scale, a_s = _mk(8, 64, 128, 1, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul(x.T.contiguous().T, w_int, w_scale, a_s, torch.float32)
    with pytest.raises(TypeError):
        int8_matmul(x.half(), w_int, w_scale, a_s, torch.float32)
    with pytest.raises(TypeError):
        int8_matmul(x, w_int.to(torch.int16), w_scale, a_s, torch.float32)
    with pytest.raises(ValueError, match="shapes"):
        int8_matmul(x, w_int[:32], w_scale, a_s, torch.float32)
    with pytest.raises(ValueError, match="0-d"):
        int8_matmul(x, w_int, w_scale, a_s.reshape(1), torch.float32)
    with pytest.raises(ValueError, match="cpu"):
        int8_matmul(x, w_int, w_scale.cpu(), a_s, torch.float32)


def _lands_on(target, a_s):
    """An fp32 x whose quantizer input fl(fl(x / a_s) * 127) is exactly
    ``target`` (searched among x's fp32 neighbours)."""
    x = np.float32(target * a_s / 127.0)
    for _ in range(64):
        v = np.float32(np.float32(x / a_s) * np.float32(127.0))
        if v == target:
            return x
        x = np.nextafter(x, np.float32(np.inf if v < target else -np.inf),
                         dtype=np.float32)
    raise AssertionError(f"no fp32 input lands on {target}")


def test_kernel_rounds_half_to_even(cuda):
    a_s = np.float32(127.0)         # with w_scale 127 the epilogue scale is 1
    targets = [0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 126.5, -127.5]
    even = [0, 2, 2, 0, -2, 4, 126, -128]      # half away from zero differs
    x = torch.tensor([[_lands_on(t, a_s) for t in targets]], device=cuda)
    K = len(targets)
    out = int8_matmul(x, torch.eye(K, dtype=torch.int8, device=cuda),
                      torch.full((K,), 127.0, device=cuda),
                      torch.tensor(a_s, device=cuda), torch.float32)
    assert out[0].tolist() == even
