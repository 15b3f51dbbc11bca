#!/usr/bin/env python3
"""Decode speed of the batch-1 serve, on one NVIDIA GPU.

    python3 tools/decode_serve_time.py [--src DIR] [--arch A ...]

Serves what ``chip_smoke.py``'s serve phase serves, for each ``--arch``
at full width in bf16 (random weights from seed 0): the 8 queries of
``generate_stream(seed=0)`` at ``paper_problem(lam=0.1, alpha=30)``
through ``LLMServer`` and ``DecodeEngine(cache_capacity=2048,
chunk=16)``, after one warm-up request. Reports the serve's wall time,
its prefill and decode seconds (prefill timed inside, each call ended by
a synchronise) and decode tokens/s. ``--src`` imports ``repro_torch``
from another tree's ``src`` (for instance a parent commit unpacked with
``git archive``), so the chunk path of two versions (an eager loop of
decode steps, or a replayed CUDA graph of one) can be compared inside one
call on one card: parent, change, change, parent, one process each.
Prints the card's name and power limit, then one JSON object per model.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def serve(arch: str, dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import paper_problem
    from repro_torch.models import init_params
    from repro_torch.queueing_sim import generate_stream
    from repro_torch.serving import DecodeEngine, LLMServer, ServerConfig

    cfg = get_config(arch)
    engine = DecodeEngine(cfg, init_params(cfg, seed=0, device=dev),
                          cache_capacity=2048, chunk=16)
    engine.generate(np.ones((1, 16), np.int32), [4], max_extra_tokens=0)
    prefill_s = [0.0]
    prefill = engine.prefill

    def timed_prefill(prompts):
        t0 = time.perf_counter()
        out = prefill(prompts)
        torch.cuda.synchronize()
        prefill_s[0] += time.perf_counter() - t0
        return out

    engine.prefill = timed_prefill
    prob = paper_problem(lam=0.1, alpha=30.0)
    srv = LLMServer(prob, ServerConfig(generate_tokens=True), engine=engine)
    stream = generate_stream(prob.tasks, 0.1, 8, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = srv.run(stream)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decode_s = wall - prefill_s[0]
    return {"arch": arch, "tokens": rep.tokens_generated, "wall_s": wall,
            "prefill_s": prefill_s[0], "decode_s": decode_s,
            "decode_tokens_per_s": rep.tokens_generated / decode_s}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--arch", action="append",
                    default=None, help="default: qwen3-0.6b")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_serve_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import _build

    _build.build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    for arch in args.arch or ["qwen3-0.6b"]:
        print(json.dumps({"src": args.src, **serve(arch, dev)}))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
