#!/usr/bin/env python3
"""Where a split-KV decode tile's time goes, on one NVIDIA GPU.

    PYTHONPATH=src python3 tools/decode_split_probe.py

Times the slot decode kernel (``csrc/decode_attention.cu``) at batch 1,
qwen3-0.6b's widths (8 kv heads, G 2, hd 128, bf16, C 2048) with the
split plan forced to n_split = 1 and 8 and a growing number of valid
slots, so the slope over tiles per CTA reads the cost of one 64-row tile.
Then the same with variants of ``csrc/decode_split.cuh`` compiled from
patched copies under ``build/probe/``: without the tile's compute, without
its copies, and without both. Each number is the profiler's device time
of the kernel, averaged over 20 calls, L2 flushed before each; one JSON
object per line, after the card's name and power limit. First, ptxas's
registers and spills for every instantiation of both decode kernels.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

VARIANTS = {"base": (1, 1), "no_compute": (0, 1), "no_copy": (1, 0),
            "neither": (0, 0)}               # (compute, copy)
COMPUTE = "    for (int r0 = 0; r0 < tile; r0 += kU * RG) {"
COPY = "    if (i < n && cr0 < crs) {"


def build_variants(out: pathlib.Path) -> dict:
    """One library per variant, from patched copies of the sources."""
    from repro_torch.kernels import _build

    src = _build.CSRC
    hdr = (src / "decode_split.cuh").read_text()
    if COMPUTE not in hdr or COPY not in hdr:
        raise RuntimeError("decode_split.cuh changed: update the probe")
    hdr = hdr.replace(COMPUTE, COMPUTE.replace("r0 < tile", "r0 < tile * "
                                               "PROBE_COMPUTE"))
    hdr = hdr.replace(COPY, COPY.replace("if (", "if (PROBE_COPY && "))
    out.mkdir(parents=True, exist_ok=True)
    (out / "decode_split.cuh").write_text(hdr)
    for name in ("common.cuh", "decode_attention.cu"):
        (out / name).write_text((src / name).read_text())
    procs = {}
    for name, (compute, copy) in VARIANTS.items():
        lib = out / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS,
             f"-DPROBE_COMPUTE={compute}", f"-DPROBE_COPY={copy}", "-o",
             str(lib), str(out / "decode_attention.cu")]))
    for name, (lib, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant")
    return {name: lib for name, (lib, _) in procs.items()}


def ptxas_report(out: pathlib.Path) -> None:
    """Print registers and spill bytes of each split-kernel instantiation
    (nvcc -Xptxas -v, the build's flags)."""
    from repro_torch.kernels import _build

    for name in ("decode_attention", "paged_decode_attention"):
        run = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(out / f"ptxas_{name}.so"), str(_build.CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=True)
        log = run.stdout + run.stderr
        kernel = None
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S*split\S*)", line)
            if m:
                t = re.search(r"split(?:I|IL)?(13__nv_bfloat16|f)Li(\d+)"
                              r"ELi(\d+)", m.group(1))
                kernel = {"source": name, "dtype": "bfloat16" if t and
                          t.group(1) != "f" else "float32",
                          "G_max": int(t.group(2)) if t else None,
                          "vectors_per_lane": int(t.group(3)) if t else None}
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


def device_ms(fn, flush: torch.Tensor, calls: int = 20) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and "decode_split" in ev.key) / calls / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_split_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, _cuda
    from repro_torch.kernels import decode_attention as da

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    out = ROOT / "build" / "probe"
    libs = build_variants(out)
    ptxas_report(out)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    C, H, G, hd = 2048, 8, 2, 128
    q = torch.randn(1, H, G, hd, generator=gen, device=dev).bfloat16()
    cache = torch.randn(2, 1, C, H, hd, generator=gen, device=dev).bfloat16()
    k, v = cache[0].permute(0, 2, 1, 3), cache[1].permute(0, 2, 1, 3)
    plan = da.split_plan
    try:
        for name, lib in libs.items():
            _cuda._entries.clear()
            _build._libs["decode_attention"] = ctypes.CDLL(str(lib))
            for n_split in (1, 8):
                da.split_plan = (lambda *a, n_split=n_split, **kw:
                                 da.SplitPlan(64, C // 64, n_split))
                for n_valid in (64, 512, 2048):
                    valid = torch.arange(C, device=dev)[None] < n_valid
                    ms = device_ms(lambda: da.decode_attention(q, k, v,
                                                               valid), flush)
                    print(json.dumps({
                        "variant": name, "n_split": n_split,
                        "valid": n_valid,
                        "tiles_per_cta": -(-(n_valid // 64) // n_split),
                        "kernel_ms": ms}))
    finally:
        da.split_plan = plan
        _cuda._entries.clear()
        _build._libs.pop("decode_attention", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
