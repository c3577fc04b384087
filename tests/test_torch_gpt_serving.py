"""The port's GPT, ``generate()`` and dense ``ServingEngine``
(``paddle_tpu_torch``) against the JAX package at ``gpt3_tiny`` size.

Weights are the reference model's ``named_parameters()``, carried across
with ``convert.load_reference``.  Tolerances:

- fp32 logits of the plain causal and the cached forward (scalar and
  per-row ``pos``): rtol=1e-5, atol=1e-5 (same math, other summation
  order);
- inside the port, the engine with ``quant_mode=None`` equals
  ``generate()`` bitwise (the reference's own contract,
  ``tests/test_quant_paths.py:240``);
- port engine vs reference engine, ``quant_mode`` None and int8: token
  agreement >= 0.99 (the reference's own bound); fp32 first-step logits
  through the int8 weights within 1e-4;
- the same in bf16: equal picks and logits within 3% of the largest, as
  the two frameworks round bf16 at different places.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddle_tpu.framework.core import Tensor
from paddle_tpu.inference.serving import ServingEngine as RefEngine
from paddle_tpu.models import GPTForPretraining as RefGPT
from paddle_tpu.models import generation as ref_gen
from paddle_tpu.models import gpt3_tiny as ref_tiny
from paddle_tpu_torch.convert import load_reference
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.models import GPTForPretraining, gpt3_tiny
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.ops import quant_dispatch as qd

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref_model():
    m = RefGPT(ref_tiny())
    m.eval()
    return m


@pytest.fixture(scope="module")
def named(ref_model):
    return {n: np.asarray(p._value) for n, p in ref_model.named_parameters()}


@pytest.fixture(scope="module")
def model(named):
    m = GPTForPretraining(gpt3_tiny(), device="cpu")
    return load_reference(m, named).eval()


def _requests(eng):
    # the requests of tests/test_quant_paths.py:_decode
    return [eng.submit(list(range(3 + i, 10 + i)), max_new_tokens=8)
            for i in range(3)]


@pytest.fixture(scope="module")
def ref_tokens(ref_model):
    """One reference engine run per quant mode, shared by the module."""
    out = {}
    for mode in (None, "int8"):
        eng = RefEngine(ref_model, num_slots=2, chunk=4, max_seq_len=64,
                        quant_mode=mode)
        reqs = _requests(eng)
        eng.run()
        out[mode] = [list(r.tokens) for r in reqs]
    return out


def _decode(model, **kw):
    eng = ServingEngine(model, num_slots=2, chunk=4, max_seq_len=64, **kw)
    reqs = _requests(eng)
    eng.run()
    return eng, [list(r.tokens) for r in reqs]


def _agreement(a, b):
    pairs = [(u, v) for x, y in zip(a, b) for u, v in zip(x, y)]
    return sum(u == v for u, v in pairs) / len(pairs)


def _ids(B, S, seed):
    return np.random.RandomState(seed).randint(0, 1024, (B, S))


def _caches(B, MAX, spec):
    return [(torch.zeros(B, MAX, nh, d), torch.zeros(B, MAX, nh, d))
            for nh, d in spec]


def test_state_dict_matches_reference_parameters(model, ref_model):
    ref = {n: tuple(p.shape) for n, p in ref_model.named_parameters()}
    own = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert own == ref
    assert list(own) == list(ref)                    # same order, too


def test_seeded_init_equals_reference_without_conversion(named):
    m = GPTForPretraining(gpt3_tiny(), device="cpu")
    for n, p in m.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), named[n])


def test_load_reference_rejects_mismatch(named):
    m = GPTForPretraining(gpt3_tiny(), device="cpu")
    missing = dict(named)
    missing.pop("gpt.final_norm.bias")
    with pytest.raises(KeyError, match="final_norm.bias"):
        load_reference(m, missing)
    bad = dict(named)
    bad["gpt.final_norm.bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="final_norm.bias"):
        load_reference(m, bad)


def test_plain_forward_logits(model, ref_model):
    ids = _ids(2, 12, seed=1)
    ref = np.asarray(ref_model(Tensor(jnp.asarray(ids)))._value)
    with torch.no_grad():
        out = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_cached_forward_scalar_and_per_row_pos(model, ref_model):
    B, S, MAX = 2, 6, 16
    spec = model.kv_cache_spec()
    ids = _ids(B, S, seed=2)
    step = _ids(B, 1, seed=3)
    params = [p for _, p in ref_model.named_parameters()]
    ref_apply = jax.jit(ref_gen.build_apply(ref_model, params))
    ref_pv = [p._value for p in params]
    rc = [(jnp.zeros((B, MAX, nh, d)), jnp.zeros((B, MAX, nh, d)))
          for nh, d in spec]
    cc = _caches(B, MAX, spec)
    with torch.no_grad():
        # prefill at scalar pos 0, then one decode step per row at its own
        # position (row 1 rewrites position 4)
        for tok, rpos, cpos in (
                (ids, jnp.zeros((), jnp.int32), 0),
                (step, jnp.asarray([6, 4], jnp.int32),
                 torch.tensor([6, 4]))):
            rl, rc = ref_apply(ref_pv, jnp.asarray(tok, jnp.int32), rc, rpos)
            cl, cc = model(torch.from_numpy(tok), caches=cc, pos=cpos)
            np.testing.assert_allclose(cl.numpy(), np.asarray(rl), **TOL)
    for (rk, rv), (ck, cv) in zip(rc, cc):
        np.testing.assert_allclose(ck.numpy(), np.asarray(rk), **TOL)
        np.testing.assert_allclose(cv.numpy(), np.asarray(rv), **TOL)


def test_generate_matches_reference(model, ref_model):
    prompt = np.arange(3, 10)[None, :]
    ref, _ = ref_model.generate(Tensor(jnp.asarray(prompt, jnp.int32)),
                                max_new_tokens=8)
    ids, scores = gen.generate(model, prompt, max_new_tokens=8,
                               device="cpu")
    assert ids.shape == (1, 8) and scores.shape == (1, 8)
    assert ids[0].tolist() == np.asarray(ref._value)[0].tolist()


def test_engine_equals_generate_bitwise(model):
    _, toks = _decode(model)
    for i, t in enumerate(toks):
        ids, _ = gen.generate(model, np.arange(3 + i, 10 + i)[None, :],
                              max_new_tokens=8, device="cpu")
        assert t == ids[0].tolist()


@pytest.mark.parametrize("seed,eos", [(8, 986), (4, 818)])
def test_engine_stops_at_eos_like_generate(model, seed, eos):
    """eos emitted by a decode step (986) or by the prefill (818): the
    engine stops there; generate() pads after it."""
    prompt = np.random.RandomState(seed).randint(0, 1024, (1, 9))
    ref, _ = gen.generate(model, prompt, max_new_tokens=8, eos_token_id=eos,
                          pad_token_id=0, device="cpu")
    ref = ref[0].tolist()
    k = ref.index(eos)
    assert ref[k + 1:] == [0] * (7 - k)
    eng = ServingEngine(model, num_slots=2, chunk=4, max_seq_len=64,
                        eos_token_id=eos)
    req = eng.submit(prompt[0], max_new_tokens=8)
    eng.run()
    assert req.tokens == ref[:k + 1] and req.finish_reason == "eos"


@pytest.mark.parametrize("mode", [None, "int8"])
def test_engine_agrees_with_reference_engine(model, ref_tokens, mode):
    eng, toks = _decode(model, quant_mode=mode)
    assert all(len(t) == 8 for t in toks)
    assert _agreement(toks, ref_tokens[mode]) >= 0.99
    assert eng.stats["finished"] == 3 and eng.stats["decoded_tokens"] == 24


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_int8_first_step_logits_match_reference(model, ref_model, dtype):
    """Prefill logits through the quantized weights: the tied head
    transposed, every linear through quant_matmul."""
    ids = np.arange(3, 10)[None, :]
    MAX = 16
    spec = model.kv_cache_spec()
    params = [p for _, p in ref_model.named_parameters()]
    ref_pv = [p._value for p in params]
    own_pv = [p for _, p in model.named_parameters()]
    if dtype is not None:
        ref_pv = ref_gen.cast_weights(ref_model, ref_pv, jnp.bfloat16)
        own_pv = gen.cast_weights(model, own_pv, torch.bfloat16)
    ref_pv = ref_gen.quantize_weights(ref_model, ref_pv, "int8")
    own_pv = gen.quantize_weights(model, own_pv, "int8")
    assert sum(isinstance(v, qd.QuantizedWeight) for v in own_pv) == 9
    cdt = jnp.float32 if dtype is None else jnp.bfloat16
    ref_caches = [(jnp.zeros((1, MAX, nh, d), cdt),
                   jnp.zeros((1, MAX, nh, d), cdt)) for nh, d in spec]
    ref, _ = jax.jit(ref_gen.build_apply(ref_model, params))(
        ref_pv, jnp.asarray(ids, jnp.int32), ref_caches,
        jnp.zeros((), jnp.int32))
    cdt = own_pv[1].dtype                 # the position table stays float
    caches = [(torch.zeros(1, MAX, nh, d, dtype=cdt),
               torch.zeros(1, MAX, nh, d, dtype=cdt))
              for nh, d in spec]
    out, _ = gen.build_apply(model, gen.parameter_slots(model))(
        own_pv, torch.from_numpy(ids), caches, 0)
    ref = np.asarray(ref, np.float32)
    out = out.float().numpy()
    if dtype is None:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    else:
        # bf16: XLA fuses elementwise chains and rounds to bf16 at fusion
        # edges, eager torch rounds after every op; the picks must agree
        # and the logits stay within 3% of the largest (measured: 2.2%)
        np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))
        assert np.abs(out - ref).max() <= 0.03 * np.abs(ref).max()
    # the swap leaves the model's own parameters in place
    assert all(not isinstance(getattr(m, a), qd.QuantizedWeight)
               for m, a in gen.parameter_slots(model))


def test_launches_and_one_host_copy_per_chunk(model, monkeypatch):
    """Every linear and the head of every prefill and every decode step
    go through int8_matmul (2 layers x 4 + 1 = 9 calls a step), and each
    engine cycle makes exactly one device-to-host copy."""
    calls, copies = [0], [0]
    real_mm, real_cpu = qd.int8_matmul, torch.Tensor.cpu

    def counting_mm(*a, **k):
        calls[0] += 1
        return real_mm(*a, **k)

    def counting_cpu(self, *a, **k):
        copies[0] += 1
        return real_cpu(self, *a, **k)
    monkeypatch.setattr(qd, "int8_matmul", counting_mm)
    eng = ServingEngine(model, num_slots=2, chunk=4, max_seq_len=64,
                        quant_mode="int8")
    _requests(eng)
    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    cycles = 0
    while eng.scheduler.has_work:
        eng.step()
        cycles += 1
    monkeypatch.setattr(torch.Tensor, "cpu", real_cpu)
    st = eng.stats
    assert calls[0] == 9 * (eng.chunk * st["chunks"] + st["prefills"])
    assert copies[0] == cycles


def test_engine_follows_model_device_and_rejects_unported(model):
    eng = ServingEngine(model, num_slots=2, chunk=2, max_seq_len=32)
    assert eng.device == torch.device("cpu")
    assert all(k.device.type == "cpu" for k, _ in eng._caches)
    for kw in ({"kv_mode": "paged"}, {"spec_decode": object()},
               {"quant_mode": "fp8"}):
        with pytest.raises(NotImplementedError):
            ServingEngine(model, num_slots=2, **kw)
    with pytest.raises(ValueError, match="quant_mode"):
        ServingEngine(model, num_slots=2, quant_mode="int4")


def test_entry_points_need_cuda_unless_cpu_is_asked(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTForPretraining(gpt3_tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        gen.generate(model, np.arange(3, 10)[None, :], max_new_tokens=2)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert bad == []
