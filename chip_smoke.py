#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

The main path is GPT-125M at full width (vocab 50304, hidden 768, 12
layers, 12 heads, 1024 positions; random weights from the model's seeded
init) served through the dense continuous-batching ``ServingEngine`` with
int8 weights: every linear and the tied LM head run the hand-written
Hopper kernel ``int8_matmul`` (``paddle_tpu_torch/csrc/quant_matmul.cu``).

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. env     — card name and power limit, torch and CUDA versions; TF32 off.
2. build   — nvcc builds the kernel from the checkout's sources.
3. kernels — ``int8_matmul`` at the main path's five (K, N) shapes, M in
             {8 (decode), 256 (prefill)}, bf16 and fp32: bitwise equal to
             its plain version; median time (CUDA events, cold L2) beside
             its bound, the plain version's time, and two yardsticks the
             port never calls (``torch._int_mm`` on pre-quantized operands,
             a bf16 ``torch.matmul``).
4. model   — one 128-token fp32 prefill on the CPU (plain versions) and
             on the card: float weights agree within 1e-3 of the largest
             logit; with int8 weights every kernel launch in the path
             equals its plain version bit for bit, and the logits stay
             within the bound ``phase_model`` explains.
5. serve   — 16 requests (prompts of 32-400 tokens, 64 new tokens each)
             through the bf16 int8 engine, 8 slots, chunk 32: every request
             finishes with 64 ids in the vocab; the kernel launched exactly
             49 times for each prefill and each decode step; a second run
             gives identical tokens (that run is profiled: device busy
             share, time by kernel); agreement with the unquantized engine
             is printed, not gated.

Then one line ``{"kernels": [...]}``, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA
device, and outside a checkout of the repository.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.models import GPTForPretraining, gpt3_125m
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.ops import quant_dispatch
from paddle_tpu_torch.ops.cuda import _build
from paddle_tpu_torch.ops.cuda.quant_matmul import (int8_matmul,
                                                    int8_matmul_plain)

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 and int8 tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# the main path's (K, N) and how often one forward runs each
SHAPES = [("qkv", 768, 2304, 12), ("out", 768, 768, 12),
          ("up", 768, 3072, 12), ("down", 3072, 768, 12),
          ("head", 768, 50304, 1)]
LAUNCHES_PER_FORWARD = sum(c for *_, c in SHAPES)          # 49
COLD_BYTES = 256 << 20     # weights rotate over more than the 50 MB L2


def emit(obj):
    print(json.dumps(obj), flush=True)


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def time_ms(fn, n_iter, reps=5):
    """Median over ``reps`` of the mean time of ``n_iter`` calls of
    ``fn(i)``, by CUDA events, after a warm-up.  ``i`` counts on across
    the repeats, so a caller that picks ``copies[i % len(copies)]`` finds
    each copy cold in L2 when it comes round again."""
    i = 0
    for _ in range(2):
        fn(i)
        i += 1
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_iter):
            fn(i)
            i += 1
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / n_iter)
    return statistics.median(out)


def bound(M, K, N, x_bytes, out_bytes):
    """Least time for the function on this card: each input read once
    (x, w_int, w_scale, act_scale), the output written once, against
    2*M*K*N int8 operations."""
    moved = M * K * x_bytes + K * N + 4 * N + 4 + M * N * out_bytes
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * K * N / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_env():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "card": card(),
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})


def phase_build():
    t0 = time.perf_counter()
    path, info = _build.build("quant_matmul")
    _build.load("quant_matmul")
    emit({"phase": "build", "library": str(path.name),
          "seconds": time.perf_counter() - t0,
          "nvcc_seconds": None if info is None else info["seconds"],
          "reused": info is None,
          "ptxas": None if info is None else info["ptxas"]})


def kernel_rows(dev):
    rng = np.random.RandomState(0)
    rows = []
    for name, K, N, count in SHAPES:
        w_int = torch.from_numpy(
            rng.randint(-127, 128, (K, N)).astype(np.int8)).to(dev)
        w_scale = torch.from_numpy(
            (0.01 + 0.05 * rng.rand(N)).astype(np.float32)).to(dev)
        n_cold = math.ceil(COLD_BYTES / (K * N))
        ws = [w_int] + [w_int.clone() for _ in range(n_cold - 1)]
        wb = w_int.to(torch.bfloat16)
        wbs = [wb] + [wb.clone() for _ in range(
            math.ceil(COLD_BYTES / (2 * K * N)) - 1)]
        for M in (8, 256):
            x32 = torch.from_numpy(
                (rng.randn(M, K) * 2).astype(np.float32)).to(dev)
            for dt in (torch.bfloat16, torch.float32):
                x = x32.to(dt)
                a_s = torch.clamp_min(x.abs().amax().float(), 1e-6)
                out = int8_matmul(x, w_int, w_scale, a_s, dt)
                ref = int8_matmul_plain(x, w_int, w_scale, a_s, dt)
                torch.cuda.synchronize()
                equal = bool(torch.equal(out, ref))
                err = float((out.float() - ref.float()).abs().max())
                if not equal:
                    raise AssertionError(
                        f"int8_matmul differs from its plain version at "
                        f"{name} M={M} {dt}: max |diff| {err}")
                ms = time_ms(lambda i: int8_matmul(
                    x, ws[i % n_cold], w_scale, a_s, dt), 20)
                plain_ms = time_ms(lambda i: int8_matmul_plain(
                    x, ws[i % n_cold], w_scale, a_s, dt), 3, reps=3)
                xq = torch.clamp(torch.round(x.float() / a_s * 127), -128,
                                 127).to(torch.int8)
                int_mm_ms = None
                if M > 16 and K % 8 == 0 and N % 8 == 0:
                    int_mm_ms = time_ms(lambda i: torch._int_mm(
                        xq, ws[i % n_cold]), 20)
                xb = x.to(torch.bfloat16)
                bf16_ms = time_ms(lambda i: torch.matmul(
                    xb, wbs[i % len(wbs)]), 20)
                b_ms, b_by = bound(M, K, N, x.element_size(),
                                   out.element_size())
                rows.append({"shape": name, "M": M, "K": K, "N": N,
                             "dtype": str(dt).replace("torch.", ""),
                             "per_forward": count, "bitwise": equal,
                             "max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "int_mm_ms": int_mm_ms,
                             "bf16_matmul_ms": bf16_ms})
        del ws, wbs
    return rows


def phase_kernels(dev):
    rows = kernel_rows(dev)
    emit({"phase": "kernels", "name": "int8_matmul",
          "bitwise_vs_plain": all(r["bitwise"] for r in rows),
          "rows": rows})
    return rows


def prefill_logits(model, ids, pv):
    """One cached prefill at pos 0 with the values ``pv`` in place of the
    model's parameters, in the model's own dtype (fp32)."""
    caches = [(torch.zeros(1, ids.shape[1], nh, d, device=ids.device),
               torch.zeros(1, ids.shape[1], nh, d, device=ids.device))
              for nh, d in model.kv_cache_spec()]
    logits, _ = gen.build_apply(model, gen.parameter_slots(model))(
        pv, ids, caches, 0)
    return logits.cpu()


def compare(out, ref):
    top = float(ref.abs().max())
    return {"rel": float((out - ref).abs().max()) / top,
            "argmax_agreement": float(
                (out.argmax(-1) == ref.argmax(-1)).float().mean())}


def phase_model(cfg):
    """The card against the CPU on one 128-token fp32 prefill of GPT-125M
    from the same seeded weights.

    - float weights: the same math in another summation order, so the
      logits agree within 1e-3 of the largest and the picks on >= 98%;
    - int8 weights: every kernel launch of the card's prefill equals its
      plain version on the same inputs, bit for bit.  End to end, a
      rounding difference anywhere upstream can move an activation across
      an int8 step, and with random weights the top logits are nearly
      tied; so the card-vs-CPU difference is held to the larger of the
      1e-2 / 98% bound and three times what a one-ulp nudge of the
      position table does on the CPU alone (measured here).
    """
    cpu = GPTForPretraining(cfg, device="cpu").eval()
    gpu = GPTForPretraining(cfg).eval()
    ids = torch.from_numpy(
        np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 128)))
    float_cpu = prefill_logits(cpu, ids, list(cpu.parameters()))
    float_gpu = prefill_logits(gpu, ids.cuda(), list(gpu.parameters()))
    q_cpu = gen.quantize_weights(cpu, list(cpu.parameters()), "int8")
    q_gpu = gen.quantize_weights(gpu, list(gpu.parameters()), "int8")
    int8_cpu = prefill_logits(cpu, ids, q_cpu)
    checks = []

    def checked(x, w_int, w_scale, act_scale, out_dtype):
        out = int8_matmul(x, w_int, w_scale, act_scale, out_dtype)
        checks.append(bool(torch.equal(out, int8_matmul_plain(
            x, w_int, w_scale, act_scale, out_dtype))))
        return out
    with mock.patch.object(quant_dispatch, "int8_matmul", checked):
        int8_gpu = prefill_logits(gpu, ids.cuda(), q_gpu)
    pos = 1                      # the position table: float in both modes
    table = q_cpu[pos]
    nudged = torch.where(
        torch.rand(table.shape, generator=torch.Generator().manual_seed(0))
        < 0.5, torch.nextafter(table, torch.full_like(table, 1.0)), table)
    int8_ulp = prefill_logits(cpu, ids, q_cpu[:pos] + [nudged]
                              + q_cpu[pos + 1:])
    del cpu
    flt, q8, ulp = (compare(float_gpu, float_cpu),
                    compare(int8_gpu, int8_cpu), compare(int8_ulp, int8_cpu))
    rel_limit = max(1e-2, 3 * ulp["rel"])
    agree_limit = min(0.98, 1 - 3 * (1 - ulp["argmax_agreement"]))
    emit({"phase": "model", "float": flt, "int8": q8,
          "int8_cpu_one_ulp_nudge": ulp, "int8_rel_limit": rel_limit,
          "int8_argmax_limit": agree_limit, "kernel_launches": len(checks),
          "kernel_bitwise_in_path": all(checks)})
    finite = bool(torch.isfinite(int8_gpu).all())
    if int8_gpu.shape != (1, 128, cfg.vocab_size) or not finite:
        raise AssertionError(f"int8 prefill logits: shape "
                             f"{tuple(int8_gpu.shape)}, finite {finite}")
    if len(checks) != LAUNCHES_PER_FORWARD or not all(checks):
        raise AssertionError(f"card int8 prefill: {checks.count(False)} "
                             f"of {len(checks)} kernel launches differ "
                             f"from the plain version")
    if flt["rel"] > 1e-3 or flt["argmax_agreement"] < 0.98:
        raise AssertionError(f"card vs CPU float prefill: {flt}")
    if q8["rel"] > rel_limit or q8["argmax_agreement"] < agree_limit:
        raise AssertionError(f"card vs CPU int8 prefill: {q8}, limits "
                             f"{rel_limit} / {agree_limit}")
    return gpu


def serve(model, prompts, quant_mode):
    eng = ServingEngine(model, num_slots=8, chunk=32, max_seq_len=1024,
                        dtype="bfloat16", quant_mode=quant_mode)
    reqs = [eng.submit(p, max_new_tokens=64) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    return eng, reqs, time.perf_counter() - t0


def device_profile(prof, wall_s):
    """Device time of a profiled run: the share of the wall the card was
    busy, the int8 kernel's part, and the kernels that took the most."""
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / (wall_s * 1e3),
            "int8_matmul_ms": sum(t for n, t in by_name.items()
                                  if "int8_matmul_kernel" in n),
            "top_kernels_ms": [[n[:90], t] for n, t in top]}


def phase_serve(model, cfg):
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n)
               for n in rng.randint(32, 401, 16)]
    int8_matmul.launches = 0
    eng, reqs, wall = serve(model, prompts, "int8")
    launches = int8_matmul.launches
    st = eng.stats
    expected = LAUNCHES_PER_FORWARD * (eng.chunk * st["chunks"]
                                       + st["prefills"])
    toks = [list(r.tokens) for r in reqs]
    bad = [r.req_id for r, t in zip(reqs, toks)
           if len(t) != 64 or not all(0 <= v < cfg.vocab_size for v in t)]
    # the determinism run doubles as the profiled one (the main path's
    # counts are already read)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, reqs2, wall2 = serve(model, prompts, "int8")
    same = [list(r.tokens) for r in reqs2] == toks
    _, reqs_f, wall_f = serve(model, prompts, None)
    pairs = [(u, v) for r, t in zip(reqs_f, toks)
             for u, v in zip(r.tokens, t)]
    ttft = st["ttft_ms"]
    emit({"phase": "serve", "card": card(), "requests": len(reqs),
          "decoded_tokens": st["decoded_tokens"], "chunks": st["chunks"],
          "prefills": st["prefills"], "wall_s": wall,
          "tokens_per_s": st["decoded_tokens"] / wall,
          "ttft_ms_median": statistics.median(ttft),
          "ttft_ms_max": max(ttft), "second_run_identical": same,
          "second_run_profile": device_profile(prof, wall2),
          "launches": launches,
          "expected_launches": expected, "bf16_engine_wall_s": wall_f,
          "agreement_vs_bf16_engine": sum(u == v for u, v in pairs)
          / len(pairs)})
    if bad or launches != expected or not same:
        raise AssertionError(f"serve: bad requests {bad}, launches "
                             f"{launches} (expected {expected}), second "
                             f"run identical {same}")
    return launches


def kernel_summary(rows, launches):
    """The kernel line: the decode step's 49 launches (M = 8 slots, bf16)
    summed by shape, plus every measured row."""
    step = [r for r in rows if r["M"] == 8 and r["dtype"] == "bfloat16"]

    def total(key):
        return sum(r[key] * r["per_forward"] for r in step)
    return {"name": "int8_matmul", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/quant_matmul.cu",
            "replaces": "paddle_tpu/ops/pallas/quant_matmul.py:40",
            "replaces_function": "_qmm_kernel",
            "launches": launches,
            "bitwise_vs_plain": all(r["bitwise"] for r in rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "of": "one decode step: 12 x (qkv, out, up, down) + head, "
                  "M=8, bf16",
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in step) else "operations",
            # no single PyTorch call computes quantize + int8 GEMM +
            # dequant; the rows carry torch._int_mm and bf16 matmul times
            "library_ms": None,
            "rows": rows}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = gpt3_125m()
    phase_env()
    phase_build()
    rows = phase_kernels(dev)
    model = phase_model(cfg)
    launches = phase_serve(model, cfg)
    emit({"kernels": [kernel_summary(rows, launches)]})
    print(card(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
