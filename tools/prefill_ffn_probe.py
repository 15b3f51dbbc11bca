#!/usr/bin/env python3
"""Registers, spills and device time of the flash and FFN kernels, on one
NVIDIA GPU.

    PYTHONPATH=src python3 tools/prefill_ffn_probe.py

First ptxas's registers, shared memory and spills for every kernel
instantiation in ``csrc/flash_attention.cu`` and ``csrc/fused_ffn.cu``
(nvcc -Xptxas -v with the build's flags). Then, at the serving paths'
bf16 shapes, each call's plan, its time as ``chip_smoke.py`` takes it
(``median_ms``: CUDA events around one call, L2 flushed, the enqueue
hidden behind a spin kernel) and the profiler's device time of every
kernel it launches (the FFN's gate/up and down GEMMs apart), averaged
over 20 calls with L2 flushed before each. Last, sweeps of the plans'
free choices, each timed as above with the plan forced (the function is
the same): flash's row tiles a CTA, and the FFN's reduction splits of
its two GEMMs and whether the down GEMM launches as a programmatic
dependent of the gate/up GEMM. One JSON object per line, after
the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def ptxas_report(out: pathlib.Path) -> None:
    """One line per kernel instantiation: registers, spills, shared
    memory (static), from nvcc -Xptxas -v."""
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    for name in ("flash_attention", "fused_ffn"):
        run = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(out / f"ptxas_{name}.so"), str(_build.CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=True)
        kernel = None
        for line in (run.stdout + run.stderr).splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                kernel = {"source": name, "kernel": m.group(1)}
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and kernel is not None:
                kernel["spill_stores"] = int(m.group(1))
                kernel["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel is not None:
                print(json.dumps({**kernel, "registers": int(m.group(1))}))
                kernel = None


def device_us(fn, flush: torch.Tensor, calls: int = 20) -> dict:
    """Profiler device time of each kernel ``fn`` launches, µs a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {ev.key[:60]: ev.self_device_time_total / calls
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total
            and ("flash" in ev.key or "ffn" in ev.key)}


def main() -> int:
    if not torch.cuda.is_available():
        print("prefill_ffn_probe: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import median_ms
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import fused_ffn as ffn_mod
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_plan)
    from repro_torch.kernels.fused_ffn import ffn_plan, fused_ffn

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    ptxas_report(ROOT / "build" / "probe")
    dev = torch.device("cuda", 0)
    sms = _cuda.sm_count(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(bf16)

    flash_cases = ((1, 128, 8, 2, 128), (8, 113, 8, 2, 128),
                   (4, 113, 8, 2, 128), (1, 113, 32, 1, 112),
                   (1, 18, 8, 2, 128), (1, 1024, 8, 2, 128))
    for B, S, H, G, hd in flash_cases:
        q = randn(B, S, H, G, hd).permute(0, 2, 3, 1, 4)
        k = randn(B, S, H, hd).permute(0, 2, 1, 3)
        v = randn(B, S, H, hd).permute(0, 2, 1, 3)
        plan = flash_plan(B, H, G, S, hd, bf16, sms)
        print(json.dumps({"kernel": "flash_attention",
                          "case": f"B={B} S={S} H={H} G={G} hd={hd}",
                          "route": plan.route, "row_tiles": plan.row_tiles,
                          "ctas": plan.ctas,
                          "ms": median_ms(lambda: flash_attention(q, k, v),
                                          flush),
                          "device_us": device_us(
                              lambda: flash_attention(q, k, v), flush)}))
    weights = {}

    def ffn_inputs(T, d, f):
        if (d, f) not in weights:
            weights.clear()
            weights[d, f] = (randn(1, d, f, scale=d ** -0.5),
                             randn(1, d, f, scale=d ** -0.5),
                             randn(1, f, d, scale=f ** -0.5))
        return (randn(1, T, d),) + weights[d, f]

    for T, d, f in ((1, 1024, 3072), (8, 1024, 3072), (128, 1024, 3072),
                    (904, 1024, 3072), (1, 3584, 14336), (8, 3584, 14336),
                    (37, 3584, 14336)):
        args = ffn_inputs(T, d, f)
        plan = ffn_plan(1, T, d, f, bf16, sms)
        print(json.dumps({"kernel": "fused_ffn", "case": f"T={T} d={d} "
                          f"d_ff={f}", "regime": plan.regime,
                          "ks_up": plan.ks_up, "ks_down": plan.ks_down,
                          "pdl": plan.pdl, "ctas_up": plan.grid_up,
                          "ctas_down": plan.grid_down,
                          "ms": median_ms(lambda: fused_ffn(*args), flush),
                          "device_us": device_us(lambda: fused_ffn(*args),
                                                 flush)}))
    flash_plan_fn = fa_mod.flash_plan
    try:
        for B, S, H, G, hd in flash_cases:
            q = randn(B, S, H, G, hd).permute(0, 2, 3, 1, 4)
            k = randn(B, S, H, hd).permute(0, 2, 1, 3)
            v = randn(B, S, H, hd).permute(0, 2, 1, 3)
            base = flash_plan_fn(B, H, G, S, hd, bf16, sms)
            for rt in (1, 2, 4):
                forced = dataclasses.replace(
                    base, row_tiles=rt, rows_per_cta=16 * rt,
                    grid_x=-(-G * S // (16 * rt)))
                fa_mod.flash_plan = lambda *a, forced=forced, **kw: forced
                print(json.dumps({"sweep": "flash_attention",
                                  "case": f"B={B} S={S} H={H} G={G} "
                                          f"hd={hd}",
                                  "row_tiles": rt, "ctas": forced.ctas,
                                  "ms": median_ms(
                                      lambda: flash_attention(q, k, v),
                                      flush)}))
    finally:
        fa_mod.flash_plan = flash_plan_fn
    plan_fn = ffn_mod.ffn_plan
    try:
        for T, d, f, ks_ups, ks_downs in (
                (1, 1024, 3072, (1, 2, 3, 4, 5, 6, 8), (2, 4, 6, 8, 9, 12,
                                                        16)),
                (128, 1024, 3072, (1, 2, 3), (1, 2, 3, 4, 6)),
                (1, 3584, 14336, (1, 2), (1, 2, 3, 4, 6)),
                (37, 3584, 14336, (1, 2), (1, 2, 3, 4, 6))):
            args = ffn_inputs(T, d, f)
            for ks_up, ks_down, pdl in itertools.product(ks_ups, ks_downs,
                                                         (False, True)):
                forced = dataclasses.replace(
                    plan_fn(1, T, d, f, bf16, sms), ks_up=ks_up,
                    ks_down=ks_down, pdl=pdl,
                    scratch_bytes=ffn_mod.scratch_bytes(1, T, d, f, ks_up,
                                                        ks_down))
                ffn_mod.ffn_plan = lambda *a, forced=forced, **kw: forced
                print(json.dumps({"sweep": "fused_ffn",
                                  "case": f"T={T} d={d} d_ff={f}",
                                  "ks_up": ks_up, "ks_down": ks_down,
                                  "pdl": pdl, "ms": median_ms(
                                      lambda: fused_ffn(*args), flush)}))
    finally:
        ffn_mod.ffn_plan = plan_fn
    return 0


if __name__ == "__main__":
    sys.exit(main())
