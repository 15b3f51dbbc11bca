#!/usr/bin/env python3
"""Cost of one replayed decode step of a MoE model, on one NVIDIA GPU.

    python3 tools/moe_step_probe.py [--src DIR] [--arch A] [--batch B ...]

Loads ``--arch`` (default deepseek-moe-16b) at full width and depth in
bf16 (random weights from seed 0) into ``DecodeEngine(cache_capacity=
2048, chunk=16)``, prefills a 96-token prompt in each of ``--batch`` rows
(default 1 and 8), captures the engine's one-token step as a CUDA graph
and replays it: 4 warm replays, 32 timed ones between CUDA events
(``wall_ms`` a step), then 32 under ``torch.profiler`` (``device_ms`` a
step: the kernels' device time summed; ``kernels`` a step: the number of
kernels the step launches; the top kernels by time). ``--src`` imports
``repro_torch`` from another tree's ``src`` (for instance a parent commit
unpacked with ``git archive``), so two versions can be compared inside
one call on one card: parent, change, change, parent, one process each.
Prints the card's name and power limit, then one JSON object per batch.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = 32


def replayed_step(engine, batch: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompt = np.tile(np.arange(96, dtype=np.int32) % 97 + 1, (batch, 1))
    logits, cache = engine.prefill(prompt)
    big = np.full(batch, 10 ** 6, np.int32)
    key, _, step = engine._prepare(logits.argmax(-1), cache, big, big, None,
                                   engine.chunk)

    def replay():
        engine._graphs.run(key, step)
    for _ in range(4):
        replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(STEPS):
        replay()
    t1.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            replay()
        torch.cuda.synchronize()
    ms, count = {}, 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            ms[ev.key] = us / 1e3 / STEPS
            count += ev.count
    top = sorted(ms.items(), key=lambda kv: -kv[1])[:10]
    return {"batch": batch, "steps": STEPS,
            "wall_ms": t0.elapsed_time(t1) / STEPS,
            "device_ms": sum(ms.values()), "kernels": count / STEPS,
            "top_device_ms": {k[:80]: v for k, v in top}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--arch", default="deepseek-moe-16b")
    ap.add_argument("--batch", type=int, action="append", default=None,
                    help="default: 1 and 8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_step_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import init_params
    from repro_torch.serving import DecodeEngine

    _build.build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    engine = DecodeEngine(cfg, init_params(cfg, seed=0, device=dev),
                          cache_capacity=2048, chunk=16)
    for batch in args.batch or [1, 8]:
        print(json.dumps({"src": args.src, "arch": args.arch,
                          **replayed_step(engine, batch)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
