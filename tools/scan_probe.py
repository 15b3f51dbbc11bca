#!/usr/bin/env python3
"""Registers, spills and device time of the two scan kernels, on one
NVIDIA GPU.

    PYTHONPATH=src python3 tools/scan_probe.py [--ptxas-only]

Prints the card's name and power limit first. Then ptxas's registers,
shared memory and spills for every kernel instantiation in
``csrc/ssd_scan.cu`` and ``csrc/rwkv6_scan.cu`` (nvcc -Xptxas -v with the
build's flags); ``--ptxas-only`` stops there. Then, at the serving paths'
shapes (rwkv6-1.6b: B 1, H 32, hd 64; zamba2-7b: B 1, H 112, hd = ds =
64) for S in 18, 37, 113, 128, in bf16 and f32, each call's plan, its
time as ``chip_smoke.py`` takes it (``median_ms``: CUDA events around one
call, L2 flushed, the enqueue hidden behind a spin kernel) and the
profiler's device time per call, averaged over 20 calls with L2 flushed
before each. Then, at S 18 and 113 in bf16, the device time of timing
variants built under ``build/probe/`` with steps of the tensor-core
kernels left out (``-DSCAN_SKIP``; their results are wrong): what each
step costs is the base time less the variant's. Last, at S 113 and 128
in bf16, a sweep of the plans' free choices with the plan forced (the
function is the same): the channel slice width (16, 32, 64) of both
scans and, for RWKV6, the rows of the diagonal blocks that keep a
per-pair exp (8, 16). One JSON object per line.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCES = ("ssd_scan", "rwkv6_scan")
SERVE_S = (18, 37, 113, 128)
#: SCAN_SKIP bits of the timing variants and the step each leaves out
SKIPS = {
    "rwkv6_scan": {0: "none", 1: "cumsum",
                   2: "decay-factored operands and u bonus",
                   4: "per-pair dots", 8: "row warps' products",
                   16: "state warps' products", 31: "all but copies"},
    "ssd_scan": {0: "none", 32: "G = C B^T", 8: "scores and y",
                 2: "w o B hi/lo", 16: "state products",
                 58: "all but copies and decays"},
}


def build_variants(out: pathlib.Path) -> dict:
    """{(source, bits): library} of the timing variants, built at once."""
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, skips in SKIPS.items():
        for bits in skips:
            lib = out / f"lib{name}_skip{bits}.so"
            procs[name, bits] = (lib, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS,
                 f"-DSCAN_SKIP={bits}", "-o", str(lib),
                 str(_build.CSRC / f"{name}.cu")]))
    for key, (lib, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the {key} variant")
    return {key: lib for key, (lib, _) in procs.items()}


def ptxas_report(out: pathlib.Path) -> None:
    """One line per kernel instantiation: registers, spills, shared
    memory (static), from nvcc -Xptxas -v."""
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    for name in SOURCES:
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
            and ("rwkv6" in ev.key or "ssd" in ev.key)}


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    ptxas_report(ROOT / "build" / "probe")
    if "--ptxas-only" in sys.argv:
        return 0
    variants = build_variants(ROOT / "build" / "probe")
    from chip_smoke import median_ms
    from repro_torch.kernels import _build, _cuda
    from repro_torch.kernels import rwkv6_scan as rk
    from repro_torch.kernels import ssd_scan as sk

    dev = torch.device("cuda", 0)
    sms = _cuda.sm_count(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)

    def rwkv_args(S, dtype, H=32, hd=64):
        r, k, v = ((0.5 * torch.randn(1, S, H, hd, generator=gen,
                                      device=dev)).to(dtype).transpose(1, 2)
                   for _ in range(3))
        la = -torch.exp(1.5 * torch.randn(1, S, H, hd, generator=gen,
                                          device=dev) - 2.0).transpose(1, 2)
        u = (0.3 * torch.randn(H, hd, generator=gen, device=dev))[None] \
            .expand(1, H, hd)
        return r, k, v, la, u

    def ssd_args(S, dtype, H=112, hd=64, ds=64):
        x = torch.randn(1, S, H, hd, generator=gen, device=dev).to(dtype) \
            .transpose(1, 2)
        dt = torch.nn.functional.softplus(
            torch.randn(1, S, H, generator=gen, device=dev) - 2.0) \
            .transpose(1, 2)
        bc = torch.randn(1, S, 2 * ds, generator=gen, device=dev).to(dtype)
        return (x, dt, -dt, bc[..., :ds][:, None].expand(1, H, S, ds),
                bc[..., ds:][:, None].expand(1, H, S, ds))

    cases = (("rwkv6_scan", rk.rwkv6_scan, rwkv_args,
              lambda S, dt: rk.rwkv6_plan(1, 32, S, 64, dt, sms)),
             ("ssd_scan", sk.ssd_scan, ssd_args,
              lambda S, dt: sk.ssd_plan(1, 112, S, 64, 64, dt, sms)))
    for dtype in (torch.bfloat16, torch.float32):
        for name, fn, make, plan in cases:
            for S in SERVE_S:
                args = make(S, dtype)
                print(json.dumps({
                    "kernel": name, "case": f"S={S}",
                    "dtype": str(dtype)[6:], **plan(S, dtype).fields(),
                    "ms": median_ms(lambda: fn(*args), flush),
                    "device_us": device_us(lambda: fn(*args), flush)}))
    for name, fn, make, _ in cases:
        for S in (18, 113):
            args = make(S, torch.bfloat16)
            for bits, left_out in SKIPS[name].items():
                _cuda._entries.clear()
                _build._libs[name] = ctypes.CDLL(str(variants[name, bits]))
                try:
                    us = device_us(lambda: fn(*args), flush)
                finally:
                    _cuda._entries.clear()
                    _build._libs.pop(name, None)
                print(json.dumps({"variant": name, "case": f"S={S}",
                                  "skip": bits, "left_out": left_out,
                                  "device_us": sum(us.values())}))
    sweeps = [("ssd_scan", sk, sk.ssd_scan, ssd_args, 0)]
    sweeps += [("rwkv6_scan", rk, rk.rwkv6_scan, rwkv_args, d)
               for d in (8, 16)]
    for name, mod, fn, make, diag in sweeps:
        for S in (113, 128):
            args = make(S, torch.bfloat16)
            for width in (16, 32, 64):
                plan_fn = mod.make_plan

                def forced(*a, width=width, diag=diag, plan_fn=plan_fn):
                    p = plan_fn(*a)
                    return dataclasses.replace(
                        p, slice_width=width, n_slices=-(-p.hd // width),
                        diag_rows=diag or p.diag_rows)
                mod.make_plan = forced
                try:
                    print(json.dumps({
                        "sweep": name, "case": f"S={S}",
                        "slice_width": width,
                        **({"diag_rows": diag} if diag else {}),
                        "ms": median_ms(lambda: fn(*args), flush),
                        "device_us": device_us(lambda: fn(*args), flush)}))
                finally:
                    mod.make_plan = plan_fn
    return 0


if __name__ == "__main__":
    sys.exit(main())
