"""The port's int8 matmul module (``paddle_tpu_torch/ops/cuda/quant_matmul.py``
and ``ops/quant_dispatch.py``) against the JAX package's.

On the CPU the port's wrapper takes its plain version, which repeats the
Hopper kernel's arithmetic step for step; on the card the two are held bit
for bit by ``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``.
Tolerances:

- plain version vs the Pallas kernel body (interpret mode): the same math
  in the same order, expected bitwise; asserted at rtol=1e-6, atol=0,
  since XLA may turn the epilogue's division by the constant 127 into a
  multiply by its reciprocal (one rounding apart);
- vs the reference's XLA path ``_xla_int8``: rtol=1e-5, its epilogue
  multiplies in another order (``quant_dispatch.py:230``);
- quantize_weight: ``q`` equal, ``scale`` within 1e-7; dequant_rows equal.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops import quant_dispatch as ref_qd
from paddle_tpu.ops.pallas.quant_matmul import int8_matmul as ref_int8_matmul
from paddle_tpu_torch.ops import quant_dispatch as qd
from paddle_tpu_torch.ops.cuda.quant_matmul import (int8_matmul,
                                                    int8_matmul_plain)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # the suite runs several workers on one host
    torch.set_num_threads(1)


def _mk(M, K, N, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype("f4")
    w_int = rng.randint(-127, 128, (K, N)).astype(np.int8)
    w_scale = (0.5 + rng.rand(N)).astype("f4")
    a_s = np.float32(np.abs(x).max())
    return x, w_int, w_scale, a_s


def _port(x, w_int, w_scale, a_s, out_dtype=torch.float32):
    return int8_matmul(torch.from_numpy(x), torch.from_numpy(w_int),
                       torch.from_numpy(w_scale), torch.tensor(a_s),
                       out_dtype).float().numpy()


SHAPES = [(M, K, N) for M in (2, 16, 24) for K in (64, 96, 256)
          for N in (64, 192, 1024)]


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plain_matches_pallas_kernel(M, K, N):
    x, w_int, w_scale, a_s = _mk(M, K, N, seed=M * 7 + K + N)
    assert M * N <= 1 << 20      # the Pallas body runs, not its fallback
    ref = ref_int8_matmul(jnp.asarray(x), jnp.asarray(w_int),
                          jnp.asarray(w_scale), jnp.asarray(a_s),
                          interpret=True)
    np.testing.assert_allclose(_port(x, w_int, w_scale, a_s),
                               np.asarray(ref), rtol=1e-6, atol=0)


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plain_matches_xla_reference(M, K, N):
    x, w_int, w_scale, a_s = _mk(M, K, N, seed=M * 7 + K + N)
    ref = ref_qd._xla_int8(jnp.asarray(x), jnp.asarray(w_int),
                           jnp.asarray(w_scale), jnp.asarray(a_s),
                           jnp.float32)
    np.testing.assert_allclose(_port(x, w_int, w_scale, a_s),
                               np.asarray(ref), rtol=1e-5, atol=0)


def test_bf16_activations_match_pallas_kernel():
    x, w_int, w_scale, _ = _mk(16, 96, 192, seed=5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    x_ref = xb.float().numpy()                    # the same bf16 values
    a_s = np.float32(np.abs(x_ref).max())
    ref = ref_int8_matmul(jnp.asarray(x_ref).astype(jnp.bfloat16),
                          jnp.asarray(w_int), jnp.asarray(w_scale),
                          jnp.asarray(a_s), out_dtype=jnp.float32,
                          interpret=True)
    out = int8_matmul(xb, torch.from_numpy(w_int), torch.from_numpy(w_scale),
                      torch.tensor(a_s), torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=0)


def test_quant_matmul_matches_reference_dispatch():
    """The dispatch takes one global absmax over every row of x."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 64).astype("f4")
    w = rng.randn(64, 96).astype("f4")
    ref_qw = ref_qd.quantize_weight(jnp.asarray(w), "int8")
    ref = ref_qd._quant_matmul(jnp.asarray(x), ref_qw.q, ref_qw.scale,
                               mode="int8", impl="pallas", interpret=True,
                               out_dtype="float32")
    out = qd.quant_matmul(torch.from_numpy(x),
                          qd.quantize_weight(torch.from_numpy(w), "int8"))
    assert out.shape == (2, 5, 96) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("transposed", [False, True])
def test_quantize_weight_matches_reference(transposed):
    rng = np.random.RandomState(4)
    w = rng.randn(48, 80).astype("f4")
    w[:, 3] = 0.0                                   # an all-zero channel
    wt = torch.from_numpy(w)
    wj = jnp.asarray(w)
    if transposed:
        wt, wj = wt.T, wj.T
    ref = ref_qd.quantize_weight(wj, "int8")
    qw = qd.quantize_weight(wt, "int8")
    assert qw.q.dtype == torch.int8 and qw.q.is_contiguous()
    np.testing.assert_array_equal(qw.q.numpy(), np.asarray(ref.q))
    np.testing.assert_allclose(qw.scale.numpy(), np.asarray(ref.scale),
                               rtol=0, atol=1e-7)


def test_quantize_weight_modes():
    w = torch.ones(4, 4)
    with pytest.raises(NotImplementedError, match="fp8"):
        qd.quantize_weight(w, "fp8")
    with pytest.raises(ValueError, match="mode"):
        qd.quantize_weight(w, "int4")


def test_dequant_rows_matches_reference():
    rng = np.random.RandomState(2)
    table = rng.randn(40, 16).astype("f4")                 # (V, H)
    ids = np.array([[0, 7, 39], [7, 1, 2]])
    ref = ref_qd.dequant_rows(ref_qd.quantize_weight(jnp.asarray(table).T,
                                                     "int8"),
                              jnp.asarray(ids))
    qw = qd.quantize_weight(torch.from_numpy(table).T, "int8")
    rows = qd.dequant_rows(qw, torch.from_numpy(ids))
    assert rows.shape == (2, 3, 16)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ref))


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


def test_quantize_rounds_half_to_even():
    a_s = np.float32(127.0)         # with w_scale 127 the epilogue scale is 1
    targets = [0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 126.5, -127.5]
    even = [0, 2, 2, 0, -2, 4, 126, -128]      # half away from zero differs
    x = np.array([[_lands_on(t, a_s) for t in targets]], dtype=np.float32)
    K = len(targets)
    eye = np.eye(K, dtype=np.int8)
    w_scale = np.full((K,), 127.0, np.float32)
    np.testing.assert_array_equal(_port(x, eye, w_scale, a_s)[0], even)
    ref = ref_int8_matmul(jnp.asarray(x), jnp.asarray(eye),
                          jnp.asarray(w_scale), jnp.asarray(a_s),
                          interpret=True)
    np.testing.assert_array_equal(np.asarray(ref)[0], even)


def test_cpu_tensor_takes_plain_version_uncounted():
    x, w_int, w_scale, a_s = _mk(3, 64, 64, seed=9)
    before = int8_matmul.launches
    args = (torch.from_numpy(x), torch.from_numpy(w_int),
            torch.from_numpy(w_scale), torch.tensor(a_s))
    out = int8_matmul(*args, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and int8_matmul.launches == before
    assert torch.equal(out, int8_matmul_plain(*args, torch.bfloat16))
