#!/usr/bin/env python3
"""Prefill time of the recurrent and hybrid serves, on one NVIDIA GPU.

    python3 tools/scan_prefill_time.py [--src DIR] [--reps N] [--arch ...]

Times what ``chip_smoke.py``'s serve phase calls prefill for
``rwkv6-1.6b`` and ``zamba2-7b`` at full width in bf16 (random weights
from seed 0): ``DecodeEngine.prefill`` of the 8 prompts of
``generate_stream(seed=0)`` at ``paper_problem(lam=0.1, alpha=30)``
(18-113 tokens, the server's ``arange(L) % 97 + 1``), one after another,
each ended by a synchronise; ``--reps`` passes, after one warm-up pass.
Then one profiled pass: the device time of the scan kernels (every kernel
whose name holds ``rwkv6`` or ``ssd``) and of all kernels, and where the
host's time went (its largest entries by self time). Last, the
host's time a scan call through the models' adapter (``kernels.ops``) at
the longest prompt's layer shape, over 200 calls with no synchronise
between them (the host, not the card, sets that pace). ``--src``
imports ``repro_torch`` from another tree's ``src`` (for instance a
parent commit unpacked with ``git archive``), so two versions can be
compared inside one call on one card: parent, change, change, parent,
one process each. Prints the card's name and power limit, then one JSON
object per model.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def device_ms(fn) -> dict:
    """Profiler times of one call of ``fn``: the device time of the scan
    kernels and of all kernels, and the host's eight largest entries by
    self time (runtime calls and ops, ms; the profiler's own cost
    included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    events = [ev for ev in avg if ev.device_type == DeviceType.CUDA]
    host = sorted((ev for ev in avg if ev.device_type == DeviceType.CPU),
                  key=lambda ev: ev.self_cpu_time_total, reverse=True)
    return {"scan_device_ms": sum(
                ev.self_device_time_total for ev in events
                if "rwkv6" in ev.key or "ssd" in ev.key) / 1e3,
            "all_device_ms": sum(ev.self_device_time_total
                                 for ev in events) / 1e3,
            "host_top_ms": {ev.key[:40]: ev.self_cpu_time_total / 1e3
                            for ev in host[:8]}}


def host_us(fn, calls: int = 200) -> float:
    """Host time a call of ``fn``, µs, with no synchronise between calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def scan_call(cfg, S: int, dev):
    """One scan call at the model's layer shape, as its layer makes it."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    bf16 = torch.bfloat16
    if cfg.backbone_kind == "rwkv6":
        from repro_torch.models.rwkv6 import dims
        nh, hd = dims(cfg)
        r, k, v = (randn(1, S, nh, hd, dtype=bf16) for _ in range(3))
        la, u = -torch.exp(randn(1, S, nh, hd) - 2.0), randn(nh, hd)
        return lambda: ops.rwkv6_scan(r, k, v, la, u)
    from repro_torch.models.mamba2 import dims
    _, nh, hd, ds = dims(cfg)
    x, bc = randn(1, S, nh, hd, dtype=bf16), randn(1, S, 2 * ds, dtype=bf16)
    dt = torch.nn.functional.softplus(randn(1, S, nh) - 2.0)
    return lambda: ops.ssd_scan(x, dt, -dt, bc[..., :ds], bc[..., ds:])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--arch", nargs="+",
                    default=["rwkv6-1.6b", "zamba2-7b"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_prefill_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.core import paper_problem
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import init_params
    from repro_torch.queueing_sim import generate_stream
    from repro_torch.serving import DecodeEngine

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lens = [q.prompt_len for q in generate_stream(
        paper_problem(lam=0.1, alpha=30.0).tasks, 0.1, 8, seed=0).queries]
    prompts = [(np.arange(n) % 97 + 1)[None].astype(np.int32) for n in lens]
    for arch in args.arch:
        cfg = get_config(arch)
        params = init_params(cfg, seed=0, device=dev)
        engine = DecodeEngine(cfg, params, cache_capacity=2048, chunk=16)

        def prefill_all():
            for p in prompts:
                engine.prefill(p)
                torch.cuda.synchronize()

        prefill_all()                              # build, load, warm up
        passes = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            prefill_all()
            passes.append(time.perf_counter() - t0)
        reset_launches()
        dev_ms = device_ms(prefill_all)
        launches = dict(LAUNCHES)
        print(json.dumps({"src": args.src, "arch": arch, "dtype": cfg.dtype,
                          "prompt_lens": lens, "prefill_s": passes,
                          "prefill_s_median": statistics.median(passes),
                          **dev_ms, "launches": launches,
                          "scan_host_us": host_us(scan_call(cfg, max(lens),
                                                            dev))}))
        del engine, params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
