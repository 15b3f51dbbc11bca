#!/usr/bin/env python3
"""Where the operating-grid solve's time goes, on one NVIDIA GPU.

    PYTHONPATH=src python3 tools/grid_probe.py [--reps N] [--device cuda]

Solves ``chip_smoke.py``'s 100-cell grid (the reference test's
lambda x alpha x l_max acceptance grid, ``paper_problem().tasks``) and its
10,000-cell grid with ``repro_torch.sweeps.solve_grid`` three ways: the
Lambert-W Newton loop's early exit read on the host every 8 steps (the
code as it stands), every step, and never (all 40 steps;
``core.lambertw._SETTLE_READ`` set past ``_NEWTON_ITERS``). The three
results must be bitwise equal. For each: the host-clock time of a solve
(median of ``--reps`` after a warm-up), and, from one profiled solve of
the 100-cell grid, its kernel launches (``cudaLaunchKernel`` calls), host
reads (``aten::_local_scalar_dense``, which every ``bool()`` / ``int()``
of a device tensor goes through), the kernels' summed device time and
that time's share of the profiled wall. Then the same counts for 8 steps
of the grid's fixed-point loop alone (per step: launches, reads). Last,
on the host (a property of the arithmetic, not a time), how far the
Armijo stopping test leaves l*: the 10,000-cell grid's Armijo cells
re-solved at tol 1e-10 and 1e-12, each against the grid's tol (1e-8)
and 1e-12. Prints the card's name and power limit, then one JSON
object per line.
``--device cpu`` rehearses it on the host (no launches, no device time).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

LAMS = np.linspace(0.05, 0.5, 10)
ALPHAS = np.array([10.0, 20.0, 30.0, 45.0, 60.0])
LMAXS = np.array([1024.0, 32768.0])
FINE = (100, 50)
SETTLE_READS = {"every_8": 8, "every_step": 1, "never": 41}
TIGHT_TOLS = (1e-10, 1e-12)


def grids() -> dict:
    return {
        "grid_100": (LAMS[:, None, None], ALPHAS[None, :, None],
                     LMAXS[None, None, :]),
        "grid_10000": (np.linspace(0.05, 0.5, FINE[0])[:, None, None],
                       np.linspace(10.0, 60.0, FINE[1])[None, :, None],
                       LMAXS[None, None, :]),
    }


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def profiled(fn, dev) -> dict:
    """Launches, host reads, device ms and its share of the wall of one
    call of ``fn`` under the profiler (its own cost in the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(dev)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        sync(dev)
    wall = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    count = {ev.key: ev.count for ev in avg}
    device_ms = sum(ev.self_device_time_total for ev in avg
                    if ev.device_type == DeviceType.CUDA) / 1e3
    return {"launches": sum(n for k, n in count.items()
                            if k.startswith("cudaLaunchKernel")),
            "host_reads": count.get("aten::_local_scalar_dense", 0),
            "stream_syncs": count.get("cudaStreamSynchronize", 0),
            "device_ms": device_ms, "profiled_wall_ms": wall,
            "device_busy_share": device_ms / wall}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from repro_torch.compat import resolve_device
    from repro_torch.core import fixed_point, lambertw, paper_problem
    from repro_torch.sweeps import solve_grid
    from repro_torch.sweeps.solver_grid import (TaskArrays, _CalibScales,
                                                _cells_problem)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)
    tasks = paper_problem().tasks
    default = lambertw._SETTLE_READ
    try:
        for name, axes in grids().items():
            first = None
            for label, k in SETTLE_READS.items():
                lambertw._SETTLE_READ = k
                sol = solve_grid(tasks, *axes, device=dev)       # warm-up
                times = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    sol = solve_grid(tasks, *axes, device=dev)
                    times.append((time.perf_counter() - t0) * 1e3)
                if first is None:
                    first = sol
                same = all(np.array_equal(getattr(sol, f), getattr(first, f))
                           for f in ("lengths_cont", "lengths_int",
                                     "fp_iterations", "pga_iterations"))
                if not same:
                    raise SystemExit(f"{name}: settle read {label} changed "
                                     "the result")
                row = {"grid": name, "settle_read": label,
                       "ms": statistics.median(times), "ms_all": times,
                       "bitwise_equal": same}
                if name == "grid_100":
                    row.update(profiled(lambda: solve_grid(
                        tasks, *axes, device=dev), dev))
                print(json.dumps(row), flush=True)

        # 8 steps of the fixed-point loop over the 100 cells, from l = 0
        lam, alpha, l_max = (torch.as_tensor(a.ravel().copy(), device=dev)
                             for a in np.broadcast_arrays(
                                 *grids()["grid_100"]))
        base = TaskArrays.from_taskset(tasks, dev)
        ones = torch.ones_like(lam)
        prob = _cells_problem(base, lam, alpha, l_max,
                              _CalibScales(*(ones,) * 5))
        for label, k in SETTLE_READS.items():
            lambertw._SETTLE_READ = k
            fixed_point.solve_fixed_point(prob, tol=0.0, max_iters=8)
            p = profiled(lambda: fixed_point.solve_fixed_point(
                prob, tol=0.0, max_iters=8), dev)
            print(json.dumps({"fixed_point_steps": 8, "settle_read": label,
                              "launches_per_step": p["launches"] / 8,
                              "host_reads_per_step": p["host_reads"] / 8,
                              **p}), flush=True)
    finally:
        lambertw._SETTLE_READ = default

    flat = solve_grid(tasks, *grids()["grid_10000"], device="cpu").ravel()
    cells = np.flatnonzero(flat.used_pga)
    axes = (flat.lam[cells], flat.alpha[cells], flat.l_max[cells])
    tight = {tol: solve_grid(tasks, *axes, tol=tol, device="cpu")
             for tol in TIGHT_TOLS}
    finest = tight[TIGHT_TOLS[-1]].lengths_cont
    for tol, sol in ((1e-8, None), *tight.items()):
        lengths = flat.lengths_cont[cells] if sol is None else \
            sol.lengths_cont
        gap = np.max(np.abs(lengths - finest), axis=-1)
        print(json.dumps({"armijo_cells": int(cells.size), "tol": tol,
                          "against_tol": TIGHT_TOLS[-1],
                          "max_abs_gap": float(gap.max()),
                          "cells_over_1e-6": int(np.sum(gap > 1e-6)),
                          "max_pga_iterations": int(
                              flat.pga_iterations[cells].max()
                              if sol is None else sol.pga_iterations.max())
                          }), flush=True)


if __name__ == "__main__":
    main()
