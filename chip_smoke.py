#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. the build: every CUDA source in src/repro_torch/csrc, one nvcc each,
   all started together;
3. kernels: each Hopper kernel against its plain PyTorch version on the
   card at the serving path's shapes (bf16 and f32, ragged S, T = 1), with
   the maximum error beside its tolerance, the kernel's median time (CUDA
   events around one call, L2 flushed before it, the host's enqueue hidden
   behind a spin kernel), the plain version's time, one
   PyTorch library call's time where one computes the same function, and
   the bound (the larger of bytes at 3.35 TB/s and FLOPs at the card's
   peak for the dtype);
4. model: full-width qwen3-0.6b in f32 (random weights from seed 0), one
   prompt, prefill plus 8 greedy decode steps, kernels against the
   reference path (force_ref);
5. serve: full-width qwen3-0.6b in bf16 through LLMServer (virtual clock,
   real tokens) with DecodeEngine(cache_capacity=2048, chunk=16) on
   paper_problem(lam=0.1, alpha=30) and an 8-query stream (seed 0):
   exact budget enforcement, the report, prefill/decode wall seconds and
   each kernel's launch count on this run (a kernel launched 0 times
   fails); then one profiled stretch of decode steps: host wall time per
   step against the device time of its kernels.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                        # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,            # dense tensor-core bf16
              torch.float32: 67e12}              # f32 outside tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
TOL_REASON = {
    torch.bfloat16: "the repo's bf16 kernel tolerance; kernel and plain "
                    "round at the same points and differ only in f32 "
                    "summation order, i.e. about one bf16 ulp of the output",
    torch.float32: "the repo's f32 kernel tolerance; only the f32 "
                   "summation order differs",
}
FFN_F32_TOL = 1e-4
FFN_F32_REASON = ("f32 sums over d = 1024 and d_ff = 3072 terms taken in "
                  "another order than torch.matmul's")
LOGIT_TOL = 1e-3
LOGIT_REASON = ("f32 end to end; kernels and reference sum in other orders "
                "and the difference compounds over 28 layers; 1e-3 is about "
                "0.1% of the logits' scale")
# the serving path's shapes at qwen3-0.6b's widths (batch_size 1)
H, G, HD, D, DFF = 8, 2, 128, 1024, 3072


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, flush: torch.Tensor, reps: int = 25) -> float:
    """Median of per-call CUDA-event times, L2 flushed before each call.

    A spin kernel queued ahead of the start event keeps the card busy while
    the host enqueues ``fn``, so the interval holds device time only, not
    the host's launch gaps (which would otherwise inflate functions made of
    many small PyTorch ops)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)             # ~1 ms of spinning
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def compare(got, want, atol, rtol) -> tuple:
    diff = (got.float() - want.float()).abs()
    ok = bool(torch.all(diff <= atol + rtol * want.float().abs()))
    return float(diff.max()), ok


def kernel_cases(dev, flush):
    """Every kernel against its plain version at the serving path's shapes.
    Returns (rows, {kernel: row of the JSON summary})."""
    import torch.nn.functional as F

    from repro_torch.kernels import (decode_attention, flash_attention,
                                     fused_ffn)

    gen = torch.Generator(device=dev).manual_seed(0)
    rows, summary = [], {}

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def record(name, case, dtype, got, want, tol, reason, fn, plain, lib,
               nbytes, flops, main):
        err, ok = compare(got, want, tol, tol)
        bms, by = bound(nbytes, flops, dtype)
        row = {"name": name, "case": case, "dtype": str(dtype)[6:],
               "max_abs_err": err, "tol": tol, "tol_reason": reason,
               "ok": ok, "ms": median_ms(fn, flush),
               "plain_ms": median_ms(plain, flush),
               "library_ms": None if lib is None else median_ms(lib, flush),
               "bound_ms": bms, "bound_by": by}
        print(json.dumps(row))
        rows.append(row)
        check(ok, f"{name} {case} {row['dtype']}: max err {err} > tol {tol}")
        if main:
            summary[name] = row

    # -- 1. prefill flash attention: q [B,S,nh,hd], k/v [B,S,nkv,hd] views
    for dtype, S in ((torch.bfloat16, 16), (torch.bfloat16, 37),
                     (torch.bfloat16, 128), (torch.float32, 37),
                     (torch.float32, 128)):
        qm = randn(1, S, H * G, HD, dtype=dtype)
        km = randn(1, S, H, HD, dtype=dtype)
        vm = randn(1, S, H, HD, dtype=dtype)
        q = qm.reshape(1, S, H, G, HD).permute(0, 2, 3, 1, 4)
        k, v = km.permute(0, 2, 1, 3), vm.permute(0, 2, 1, 3)
        fa = flash_attention.flash_attention
        got = fa(q, k, v)
        want = flash_attention.flash_attention_plain(q, k, v)
        ql = qm.transpose(1, 2)
        kl = k.repeat_interleave(G, dim=1)
        vl = v.repeat_interleave(G, dim=1)
        mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
        el = qm.element_size()
        nbytes = (2 * H * G + 2 * H) * S * HD * el
        flops = H * G * S * (S + 1) / 2 * 4 * HD
        record("flash_attention", f"B=1 S={S} H={H} G={G} hd={HD}", dtype,
               got, want, TOL[dtype], TOL_REASON[dtype],
               lambda: fa(q, k, v),
               lambda: flash_attention.flash_attention_plain(q, k, v),
               lambda: F.scaled_dot_product_attention(ql, kl, vl,
                                                      attn_mask=mask),
               nbytes, flops, main=(dtype == torch.bfloat16 and S == 128))

    # -- 2. slot decode attention over the stacked cache's [B,C,nkv,hd]
    C = 2048
    for dtype, B, n_valid in ((torch.bfloat16, 1, (17,)),
                              (torch.bfloat16, 1, (300,)),
                              (torch.float32, 1, (300,)),
                              (torch.float32, 2, (45, 1500))):
        q = randn(B, H, G, HD, dtype=dtype)
        kc = randn(B, C, H, HD, dtype=dtype)
        vc = randn(B, C, H, HD, dtype=dtype)
        k, v = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
        lens = torch.tensor(n_valid, device=dev)[:, None]
        valid = torch.arange(C, device=dev)[None] < lens
        da = decode_attention.decode_attention
        got = da(q, k, v, valid)
        want = decode_attention.decode_attention_plain(q, k, v, valid)
        ql = q.reshape(B, H * G, 1, HD)
        kl = k.repeat_interleave(G, dim=1)
        vl = v.repeat_interleave(G, dim=1)
        lmask = valid[:, None, None, :]
        el = q.element_size()
        rows_read = sum(n_valid)
        nbytes = (2 * B * H * G * HD + 2 * rows_read * H * HD) * el + B * C
        flops = 4 * rows_read * H * G * HD
        record("decode_attention",
               f"B={B} C={C} valid={list(n_valid)} H={H} G={G} hd={HD}",
               dtype, got, want, TOL[dtype], TOL_REASON[dtype],
               lambda: da(q, k, v, valid),
               lambda: decode_attention.decode_attention_plain(q, k, v,
                                                               valid),
               lambda: F.scaled_dot_product_attention(ql, kl, vl,
                                                      attn_mask=lmask),
               nbytes, flops,
               main=(dtype == torch.bfloat16 and n_valid == (300,)))

    # -- 3. fused SwiGLU FFN, E = 1: T = 1 at decode, T = S at prefill
    for dtype, T in ((torch.bfloat16, 1), (torch.bfloat16, 37),
                     (torch.bfloat16, 128), (torch.float32, 1),
                     (torch.float32, 128)):
        x = randn(1, T, D, dtype=dtype)
        wg = randn(1, D, DFF, dtype=dtype, scale=D ** -0.5)
        wu = randn(1, D, DFF, dtype=dtype, scale=D ** -0.5)
        wd = randn(1, DFF, D, dtype=dtype, scale=DFF ** -0.5)
        ff = fused_ffn.fused_ffn
        got = ff(x, wg, wu, wd)
        want = fused_ffn.fused_ffn_plain(x, wg, wu, wd)
        tol, reason = ((FFN_F32_TOL, FFN_F32_REASON)
                       if dtype == torch.float32
                       else (TOL[dtype], TOL_REASON[dtype]))
        el = x.element_size()
        nbytes = (2 * T * D + 3 * D * DFF) * el
        flops = 6 * T * D * DFF
        record("fused_ffn", f"E=1 T={T} d={D} d_ff={DFF}", dtype, got, want,
               tol, reason, lambda: ff(x, wg, wu, wd),
               lambda: fused_ffn.fused_ffn_plain(x, wg, wu, wd), None,
               nbytes, flops, main=(dtype == torch.bfloat16 and T == 1))
    return rows, summary


def model_phase(dev) -> dict:
    """Full-width f32 qwen3-0.6b: kernels against force_ref, teacher-forced
    on the reference's greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_params

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), dtype="float32")
    params = init_params(cfg, seed=0, device=dev)
    prompt = torch.as_tensor(np.arange(37) % 97 + 1, device=dev)[None]
    ref = forward(cfg, params, prompt, return_cache=True, cache_capacity=64,
                  force_ref=True)
    ker = forward(cfg, params, prompt, return_cache=True, cache_capacity=64)
    err = float((ref.logits - ker.logits).abs().max())
    scale = float(ref.logits.abs().max())
    tok = ref.logits[:, -1:].argmax(-1)
    agree = bool(torch.equal(ker.logits[:, -1:].argmax(-1), tok))
    cr, ck = ref.cache, ker.cache
    for _ in range(8):
        r = decode_step(cfg, params, tok, cr, force_ref=True)
        k = decode_step(cfg, params, tok, ck)
        err = max(err, float((r.logits - k.logits).abs().max()))
        scale = max(scale, float(r.logits.abs().max()))
        tok = r.logits.argmax(-1)
        agree &= bool(torch.equal(k.logits.argmax(-1), tok))
        cr, ck = r.cache, k.cache
    out = {"phase": "model", "arch": cfg.arch_id, "dtype": "float32",
           "prompt_len": 37, "decode_steps": 8,
           "logits_max_abs_err": err, "logits_max_abs": scale,
           "tol": LOGIT_TOL, "tol_reason": LOGIT_REASON,
           "greedy_tokens_agree": agree}
    print(json.dumps(out))
    check(err <= LOGIT_TOL, f"model logits err {err} > {LOGIT_TOL}")
    del params
    torch.cuda.empty_cache()
    return out


def serve_phase(dev) -> dict:
    """The main path: allocator -> scheduler -> LLMServer -> DecodeEngine."""
    from repro_torch.configs import get_config
    from repro_torch.core import paper_problem
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import init_params
    from repro_torch.queueing_sim import generate_stream
    from repro_torch.serving import DecodeEngine, LLMServer, ServerConfig

    cfg = get_config("qwen3-0.6b")
    params = init_params(cfg, seed=0, device=dev)
    engine = DecodeEngine(cfg, params, cache_capacity=2048, chunk=16)
    engine.generate(np.ones((1, 16), np.int32), [4], max_extra_tokens=0)
    timers = {"prefill_s": 0.0, "generate_s": 0.0}
    prefill, generate = engine.prefill, engine.generate

    def timed_prefill(prompts):
        t0 = time.perf_counter()
        out = prefill(prompts)
        torch.cuda.synchronize()
        timers["prefill_s"] += time.perf_counter() - t0
        return out

    def timed_generate(*args, **kwargs):
        t0 = time.perf_counter()
        out = generate(*args, **kwargs)       # returns host arrays: synced
        timers["generate_s"] += time.perf_counter() - t0
        return out

    engine.prefill, engine.generate = timed_prefill, timed_generate
    prob = paper_problem(lam=0.1, alpha=30.0)
    stream = generate_stream(prob.tasks, 0.1, 8, seed=0)
    srv = LLMServer(prob, ServerConfig(generate_tokens=True), engine=engine)
    sol = srv.allocator.solution
    allocation = dict(zip(prob.tasks.names,
                          sol.lengths_int.astype(int).tolist()))
    print("allocation:", json.dumps(allocation))
    reset_launches()
    t0 = time.perf_counter()
    rep = srv.run(stream)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    extra = srv.cfg.max_extra_tokens
    for c in srv.completed:
        check(c.n_tokens == c.budget + extra,
              f"request {c.rid}: {c.n_tokens} tokens for budget "
              f"{c.budget} + {extra}")
    check(rep.n == 8, f"served {rep.n} of 8 requests")
    decode_s = timers["generate_s"] - timers["prefill_s"]
    out = {"phase": "serve", "arch": cfg.arch_id, "dtype": cfg.dtype,
           "report": dataclasses.asdict(rep),
           "budgets_enforced_exactly": True,
           "wall_s": wall, "prefill_s": timers["prefill_s"],
           "decode_s": decode_s,
           "decode_tokens_per_s": rep.tokens_generated / decode_s,
           "launches": launches,
           "prompt_lens": [q.prompt_len for q in stream.queries]}
    print(json.dumps(out))
    for name in ("flash_attention", "decode_attention", "fused_ffn"):
        check(launches.get(name, 0) > 0,
              f"{name} was launched 0 times on the main path")
    print(json.dumps(decode_step_breakdown(engine, prefill)))
    return out


def decode_step_breakdown(engine, prefill, steps: int = 16) -> dict:
    """Where a full-width decode step's time goes: host wall time per step
    (synchronised) against the device time of the kernels the profiler
    saw, at position ~100 of a 2048-slot cache."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    logits, cache = prefill(np.arange(96, dtype=np.int32)[None] % 97 + 1)
    token = logits.argmax(-1)
    for _ in range(4):                               # warm
        token, cache = engine._step(token, cache, None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        token, cache = engine._step(token, cache, None)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            token, cache = engine._step(token, cache, None)
        torch.cuda.synchronize()
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:    # CPU ops would count twice
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            per_kernel[ev.key] = us / 1e3 / steps
    device_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"phase": "decode_step_breakdown", "steps": steps,
            "wall_ms_per_step": wall_ms,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "top_device_ms_per_step": {k[:80]: v for k, v in top}}


REPLACES = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:98"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:170"),
    "fused_ffn": ("src/repro_torch/csrc/fused_ffn.cu",
                  "src/repro/kernels/fused_ffn.py:57"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False     # f32 means f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    per_source = _build.build()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "per_source_s": per_source}))

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    _, summary = kernel_cases(dev, flush)
    del flush
    model_phase(dev)
    served = serve_phase(dev)

    kernels = []
    for name, (source, replaces) in REPLACES.items():
        row = summary[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": served["launches"][name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
