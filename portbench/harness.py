"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the plain reference that decides ``correct``.

Everything that belongs to one configuration, traffic mix, cell or metric
is found by its name in files of its own under this directory:

* ``BENCHMARK.json`` (at the repository's root) maps a cell to its
  configuration and its traffic mix, and lists the metrics;
* ``configs/<config>.json``: the published keys, the port's id and family,
  the weights' scales; ``families/<family>.py`` turns it into the port's
  ``ModelConfig`` and the parameter tree's leaves, and
  ``reference/<family>.py`` is its plain forward;
* ``mixes/<traffic>.json``: task types, the allocation problem, prompt
  lengths, answer tokens (``traffic.py`` is the one generator);
* ``cells/<cell>.json``: the engine's sizes, the arrival mode and rate,
  the warm period, the traced slice (after the window's close), the
  sample of the check and the limit of each number it compares;
* ``metrics/<metric>.py``: ``read(ctx)`` -> a number, or None where the
  run has nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import pathlib
import time
import types

import numpy as np
import torch

from . import imports, loop as loop_mod, stats, traffic, weights

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


class NoDevice(RuntimeError):
    """The card the cell asks for is missing."""


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(bench: dict, cell: str, base: pathlib.Path = HERE) -> dict:
    """The cell's entry and its files, by name."""
    work = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if work is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    return {"work": work,
            "spec": load_json(base / "configs" / f"{work['config']}.json"),
            "mix": load_json(base / "mixes" / f"{work['traffic']}.json"),
            "cell": load_json(base / "cells" / f"{cell}.json")}


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str, base: pathlib.Path = HERE):
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def problem(mix: dict):
    """The mix's allocation problem, as the port's ``core.params`` has it."""
    from repro_torch.core.params import Problem, ServerParams, TaskSet
    t, p = mix["tasks"], mix["problem"]
    tasks = TaskSet(names=tuple(t["names"]), A=t["A"], b=t["b"], D=t["D"],
                    t0=t["t0"], c=t["c"], pi=t["pi"])
    return Problem(tasks=tasks, server=ServerParams(
        lam=float(p["lam"]), alpha=float(p["alpha"]),
        l_max=float(p["l_max"])))


def n_requests(cell: dict, seconds: float) -> int:
    arr = cell["arrivals"]
    if arr["mode"] == "backlog":
        return int(arr["requests"])
    # arrivals through the warm period, the window and five seconds more
    horizon = arr["warm_s"] + seconds + 5.0
    return int(math.ceil(arr["rate"] * horizon * 1.2)) + 10


def _spans(tracer, anchor_wall: float, t0: float) -> list:
    """The port's wall spans on the loop's clock: (name, start, end, args).
    ``anchor_wall``: the perf_counter time at which the anchor span began."""
    evs = [e for e in tracer.to_chrome()["traceEvents"] if e.get("ph") == "X"]
    anchor = next(e for e in evs if e["name"] == "portbench.anchor")
    wall0 = anchor_wall - anchor["ts"] * 1e-6
    out = []
    for e in evs:
        s = wall0 + e["ts"] * 1e-6 - t0
        out.append((e["name"], s, s + e["dur"] * 1e-6, e.get("args") or {}))
    return out


def _warm_shapes(engine, mix: dict) -> None:
    """Every shape the traffic uses before the loop starts: a one-token
    request at the shortest, middle and longest prompt (each admitted
    alone, as the capacity dispatch admits, and retired by one chunk),
    which also captures the decode step's graph."""
    law = mix["prompt_len"]
    lo, hi = int(law["lo"]), int(law["hi"])
    for i, n in enumerate((lo, (lo + hi) // 2, hi)):
        if not engine.admit_many([(-1 - i, np.zeros(n, np.int64), 0, 1)])[0]:
            raise RuntimeError(f"the engine refused a warm-up prompt of {n}")
        engine.step_chunk()
    if engine.n_active:
        raise RuntimeError("a warm-up request outlived its chunk")


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        t_process: float, bench: dict | None = None,
        base: pathlib.Path = HERE, device: str | None = None,
        control: bool = False, probe: bool = False) -> tuple:
    """One run; returns (result line dict, checks list). ``device`` None
    takes the card (and raises :class:`NoDevice` without one); the CPU
    tests pass ``"cpu"`` at a small configuration. ``control`` and
    ``probe``: as ``check.run`` takes them (``control.py``)."""
    if bench is None:
        bench = load_json(ROOT / "BENCHMARK.json")
    f = find(bench, cell_name, base)
    spec, mix, cell = f["spec"], f["mix"], f["cell"]
    chips = f["work"]["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoDevice(f"the cell needs {chips} CUDA device(s); "
                           f"torch sees {torch.cuda.device_count()}")
        device = "cuda"
    dev = torch.device(device)
    from repro_torch.core.allocator import TokenBudgetAllocator
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving.continuous import ContinuousBatchingEngine
    from repro_torch.serving.request import Request as PortRequest
    from repro_torch.serving.scheduler import Scheduler

    marks = {"imported": time.perf_counter() - t_process}
    family = importlib.import_module(f"portbench.families.{spec['family']}")
    cfg = family.port_config(spec)
    leaves = family.leaves(spec)
    params = weights.build(leaves, spec["num_hidden_layers"], seed,
                           cfg.tdtype, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    marks["weights"] = time.perf_counter() - t_process
    allocator = TokenBudgetAllocator(problem(mix))
    scheduler = Scheduler(allocator, discipline="fifo")
    arr = cell["arrivals"]
    rate = arr.get("rate") if arr["mode"] == "poisson" else None
    reqs = traffic.generate(mix, n_requests(cell, seconds), seed,
                            spec["vocab_size"], rate)
    by_rid = {r.rid: r for r in reqs}
    tracer = Tracer() if trace else None
    anchor_wall = time.perf_counter()
    if tracer is not None:
        with tracer.span("portbench.anchor"):
            pass
    engine = ContinuousBatchingEngine(cfg, params, tracer=tracer,
                                      **cell["engine"])
    _warm_shapes(engine, mix)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    marks["shapes_warm"] = time.perf_counter() - t_process

    def port_request(r):
        return PortRequest(rid=r.rid, task_index=r.task, prompt=r.prompt,
                           arrival_t=r.due, max_extra_tokens=r.max_extra)
    ol = loop_mod.OpenLoop(engine, scheduler, reqs, port_request,
                           time.perf_counter())
    if arr["mode"] == "poisson":
        t_open = float(arr["warm_s"])
        ol.run_until(t_open, by_rid)
    else:
        warm = int(arr["warm_chunks"])
        ol.run_until(math.inf, by_rid, stop=lambda lp: len(lp.chunks) >= warm)
        t_open = ol.now()
    t_close = t_open + seconds
    setup_s = ol.t0 + t_open - t_process
    ol.run_until(t_close, by_rid)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated(dev))
    else:
        peak = 0
    prof = None
    if trace:
        # the profiler's slice comes after the close, the loop serving on,
        # so that its start and stop stall nothing that the window times
        from . import profile
        pc = cell["profile"]
        prof = profile.Profiler(ol, t_close + pc["after_close_s"],
                                pc["length_s"])
        ol.hooks.append(prof.tick)
        ol.run_until(prof.t_stop, by_rid)
        prof.finish()
    # a backlog cell holds a queue all through the window
    backlog_dry = sum(arr["mode"] == "backlog" and q == 0
                      for t, q, _ in ol.queue_len if t_open <= t < t_close)

    ctx = types.SimpleNamespace(
        cell=cell_name, mode=arr["mode"], spec=spec, mix=mix, seconds=seconds,
        t_open=t_open, t_close=t_close, setup_s=setup_s, requests=reqs,
        loop=ol, spans=(_spans(tracer, anchor_wall, ol.t0)
                        if tracer is not None else []),
        profile=prof.result if prof is not None else None)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[kind]:
        if applies(m, cell_name):
            v = reader(m["name"], base)(ctx)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # poisson: the requests due in the window; backlog: those served in it
    attempted = [r for r in reqs if (t_open <= r.due < t_close
                                     if rate is not None else
                                     any(t_open <= t < t_close
                                         for t in r.read_times))]

    # the comparison, once the window has closed and the peak is read
    del engine, params, ol.engine
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from . import check
    t_check = time.perf_counter()
    checks, readings = check.run(spec, mix, cell, leaves, seed, reqs, dev,
                                 control=control, probe=probe)
    if arr["mode"] == "backlog":
        checks.append(check.Check("backlog_queue_empty", backlog_dry, 0))
    bad = [r for r in reqs if r.done and len(r.tokens) != r.budget
           + r.max_extra]
    found = imports.forbidden_loaded()
    if found:
        raise imports.Forbidden(found)
    result = {
        "correct": all(c.ok for c in checks),
        "attempted": len(attempted),
        "failed": sum(1 for r in attempted if r in bad),
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": chips, "memory_peak_bytes": peak},
    }
    if dev.type == "cuda":
        from .roofline import card
        result["device"].update(card())
    if prof is not None and prof.result is not None:
        sl = prof.result
        result["device"]["busy_s"] = sl.busy_s
        result["device"]["window_s"] = sl.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in sl.ops],
                               "idle_gaps": [list(x) for x in sl.gaps]}
    lat = sorted(ol.lateness)
    result["notes"] = {"generator_late_p50_s": lat[len(lat) // 2]
                       if lat else 0.0,
                       "generator_late_max_s": lat[-1] if lat else 0.0,
                       "requests_finished": sum(r.done for r in reqs),
                       "chunks": len(ol.chunks),
                       # the window's host-clock readings, traced or not
                       **({"window": stats.poisson_metrics(reqs, t_open,
                                                           t_close)}
                          if rate is not None else {}),
                       **{f"setup_{k}_s": v for k, v in marks.items()},
                       "reference_s": time.perf_counter() - t_check,
                       **readings}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result, checks
