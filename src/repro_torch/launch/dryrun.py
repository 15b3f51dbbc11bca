"""Multi-pod dry-run: run every (arch x shape x mesh) combo's step once on
the production mesh, shapes only (``repro.launch.dryrun``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh pod --out results/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The JAX package lowers and compiles each combo for 512 placeholder host
devices and reads XLA's memory and cost analyses. Here the production
mesh lies on PyTorch's fake process group (``launch/mesh.py``), the
parameters, caches or train state are DTensor stand-ins on
the meta device (``launch/shapes.py``), and the step runs once on rank
0's shards, on the reference math, under ``roofline.analysis``'s counters.
It runs on the CPU and allocates nothing.

Emits one JSON per combo, ``<arch>__<shape>__<pod|multipod>__<dryrun|
roofline>.json``, with per-device ``memory_analysis``
(``argument_size_in_bytes``, ``output_size_in_bytes``,
``temp_size_in_bytes``: the peak of live local bytes beyond the
arguments, ``alias_size_in_bytes``: the donated state), ``cost_analysis``
(``flops``, ``bytes accessed``), the recorded collectives, and with
``--roofline`` the roofline terms.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

from ..configs import ARCH_IDS, get_config
from ..roofline.analysis import analyze, collective_bytes, count_step
from ..sharding.context import use_mesh
from ..sharding.partition import ShardingOptions
from .mesh import make_production_mesh
from .shapes import (SHAPES, adapt_config, input_specs, params_specs_for,
                     train_state_specs)
from .steps import make_prefill_step, make_serve_step, make_train_step_fn


def lower_combo(arch: str, shape_name: str, multi_pod: bool,
                opts: ShardingOptions = ShardingOptions(),
                overrides: dict | None = None):
    """Full-depth run of the step on the production mesh: proves the
    (arch x shape x mesh) combo runs sharded, and gives its per-device
    memory, cost and collectives."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    cfg = adapt_config(cfg, shape)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    mesh = make_production_mesh(multi_pod=multi_pod)
    res, (t_place, t_run) = _lower_and_cost(cfg, shape, mesh, opts)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": mesh.size(),
        "mode": "full-eager",
        "place_s": round(t_place, 2),
        "run_s": round(t_run, 2),
        "memory_analysis": res["memory"],
        "cost_analysis": res["cost"],
        "collectives": collective_bytes(res["collectives"]),
        "options": dataclasses.asdict(opts),
        "ok": True,
    }


def _lower_and_cost(cfg, shape, mesh, opts, microbatch=None):
    """Place the stand-ins and run the step once under the counters;
    returns (``count_step``'s dict, (place seconds, run seconds))."""
    t0 = time.time()
    with use_mesh(mesh, opts):
        if shape.kind == "train":
            state, _ = train_state_specs(cfg, mesh, opts)
            spec = input_specs(cfg, shape, mesh, opts)
            step = make_train_step_fn(cfg, microbatch=microbatch)
            args, donated = (state, spec["batch"]), state
        elif shape.kind == "prefill":
            params, _ = params_specs_for(cfg, mesh, opts)
            spec = input_specs(cfg, shape, mesh, opts)
            step = make_prefill_step(cfg, force_ref=True)
            args = (params, spec["tokens"])
            if "prefix_embeds" in spec:
                args += (spec["prefix_embeds"],)
            donated = None
        else:
            params, _ = params_specs_for(cfg, mesh, opts)
            spec = input_specs(cfg, shape, mesh, opts)
            step = make_serve_step(cfg, force_ref=True)
            args, donated = (params, spec["token"], spec["cache"]), \
                spec["cache"]
        t_place = time.time() - t0
        res = count_step(step, args, donated)
    res.pop("out")
    return res, (t_place, time.time() - t0 - t_place)


def _depth_points(cfg):
    """Two (or three) reduced depths for the affine cost extrapolation."""
    if cfg.has_shared_attn:
        g = cfg.attn_every
        rem = cfg.n_layers % g
        pts = [g, 2 * g]
        if rem:
            pts.append(g + rem)
        return pts
    return [2, 4]


def roofline_combo(arch: str, shape_name: str,
                   opts: ShardingOptions = ShardingOptions(),
                   multi_pod: bool = False, overrides: dict | None = None,
                   mesh_shape: tuple | None = None):
    """Roofline terms via depth extrapolation.

    The JAX package needs it because XLA's cost analysis counts a scanned
    layer body once: it lowers unrolled variants at two depths, and every
    cost component is exactly affine in depth (R + L*B: embeddings, head
    and optimizer constants plus a per-layer body), so two points give
    the production depth (it unrolls them with ``unroll_layers``). The
    port's layers run in an eager Python loop, each counted as it runs,
    so it needs no such option and the extrapolation equals the direct
    full-depth count (a test holds it to that); it is kept for the JAX
    package's JSON and its speed. Hybrid stacks use group-count points
    (+ a remainder point).
    """
    base = get_config(arch)
    shape = SHAPES[shape_name]
    base = adapt_config(base, shape)
    if overrides:
        base = dataclasses.replace(base, **overrides)
    mesh = make_production_mesh(multi_pod=multi_pod,
                                shape_override=mesh_shape)
    pts = _depth_points(base)

    meas = {}
    run_s = 0.0
    for L in pts:
        cfg_l = dataclasses.replace(base, n_layers=L)
        res, (tp, tr) = _lower_and_cost(cfg_l, shape, mesh, opts)
        coll = collective_bytes(res["collectives"])
        meas[L] = {
            "flops": float(res["cost"]["flops"]),
            "bytes": float(res["cost"]["bytes accessed"]),
            "coll": float(coll["total"]),
            "counts": coll["counts"],
        }
        run_s += tp + tr

    full = extrapolate(base, meas, pts)
    cost_full = {"flops": full["flops"], "bytes accessed": full["bytes"]}
    roof = analyze(cost_full, (), base, shape, mesh.size())
    # patch in the extrapolated collective term (analyze saw no records)
    from ..roofline.analysis import COLLECTIVE_BW
    roof.collective_bytes_per_device = full["coll"]
    roof.collective_s = full["coll"] / COLLECTIVE_BW
    terms = {"compute": roof.compute_s, "memory": roof.memory_s,
             "collective": roof.collective_s}
    roof.bottleneck = max(terms, key=terms.get)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": mesh.size(),
        "mode": "roofline-extrapolated",
        "depth_points": pts,
        "measurements": meas,
        "roofline": roof.as_dict(),
        "run_s": round(run_s, 2),
        "options": dataclasses.asdict(opts),
        "ok": True,
    }


def extrapolate(base, meas: dict, pts: list) -> dict:
    """Full-depth flops, bytes and collective bytes from the depth points'
    measurements (affine in depth; per group for the hybrid)."""
    L1, L2 = pts[0], pts[1]
    full = {}
    if base.has_shared_attn:
        g = base.attn_every
        n_groups = base.n_layers // g
        rem = base.n_layers % g
        for key in ("flops", "bytes", "coll"):
            body = (meas[L2][key] - meas[L1][key])        # per group
            const = meas[L1][key] - body                   # embeds + head
            total = const + n_groups * body
            if rem:
                total += meas[g + rem][key] - meas[g][key]
            full[key] = total
    else:
        for key in ("flops", "bytes", "coll"):
            body = (meas[L2][key] - meas[L1][key]) / (L2 - L1)
            const = meas[L1][key] - L1 * body
            full[key] = const + base.n_layers * body
    return full


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"),
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--expert-parallel", action="store_true")
    ap.add_argument("--seq-sharded-cache", action="store_true")
    ap.add_argument("--zero-optimizer", action="store_true")
    ap.add_argument("--roofline", action="store_true",
                    help="depth-extrapolated roofline pass instead of the "
                         "full-depth run")
    ap.add_argument("--kv-repeat", type=int, default=None,
                    help="KV-head replication factor (perf variant)")
    ap.add_argument("--mesh-shape", default=None,
                    help="logical pod reshape, e.g. 32,8 (perf variant)")
    ap.add_argument("--kv-cache-dtype", default=None,
                    choices=("model", "int8"),
                    help="decode cache storage dtype (perf variant)")
    ap.add_argument("--microbatch", type=int, default=None,
                    help="grad-accumulation microbatch (perf variant)")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    opts = ShardingOptions(expert_parallel=args.expert_parallel,
                           seq_sharded_cache=args.seq_sharded_cache,
                           zero_optimizer=args.zero_optimizer)

    archs = ARCH_IDS if args.all or args.arch is None else (args.arch,)
    shapes = tuple(SHAPES) if args.all or args.shape is None \
        else (args.shape,)
    meshes = {"pod": (False,), "multipod": (True,),
              "both": (False, True)}[args.mesh]

    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for multi_pod in meshes:
                mode = "roofline" if args.roofline else "dryrun"
                tag = f"{arch}__{shape_name}__" \
                      f"{'multipod' if multi_pod else 'pod'}__{mode}" \
                      + (f"__{args.tag}" if args.tag else "")
                path = outdir / f"{tag}.json"
                if path.exists():
                    print(f"[skip] {tag} (cached)")
                    continue
                print(f"[run ] {tag}", flush=True)
                overrides = {}
                if args.kv_repeat:
                    overrides["kv_repeat"] = args.kv_repeat
                if args.kv_cache_dtype:
                    overrides["kv_cache_dtype"] = args.kv_cache_dtype
                try:
                    if args.roofline:
                        ms = tuple(int(x) for x in args.mesh_shape.split(",")) \
                            if args.mesh_shape else None
                        res = roofline_combo(arch, shape_name, opts,
                                             multi_pod=multi_pod,
                                             overrides=overrides or None,
                                             mesh_shape=ms)
                        extra = f"bottleneck={res['roofline']['bottleneck']}"
                    else:
                        res = lower_combo(arch, shape_name, multi_pod, opts,
                                          overrides=overrides or None)
                        tgb = res["memory_analysis"].get(
                            "temp_size_in_bytes", 0) / 1e9
                        extra = f"temp={tgb:.1f}GB"
                    print(f"[ ok ] {tag}: run={res['run_s']}s {extra}",
                          flush=True)
                except Exception as e:  # noqa: BLE001 - one combo's failure
                    failures += 1      # is recorded in its JSON; the rest run
                    res = {"arch": arch, "shape": shape_name,
                           "mesh": "2x16x16" if multi_pod else "16x16",
                           "ok": False, "error": repr(e),
                           "traceback": traceback.format_exc(),
                           "options": dataclasses.asdict(opts)}
                    print(f"[FAIL] {tag}: {e!r}", flush=True)
                path.write_text(json.dumps(res, indent=2))
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
