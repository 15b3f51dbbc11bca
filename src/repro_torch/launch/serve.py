"""Serving launcher: the paper's system end to end, on the PyTorch port.

Streams Poisson arrivals through the allocator-driven FIFO server. With
--real-engine the model generates budget-enforced tokens; without it the
calibrated latency model drives the virtual clock alone. The model runs at
its published widths (random weights from --seed) on --device, which
defaults to cuda; --reduced gives the 2-layer CPU test variant. On the
card the engine decodes by replaying its captured CUDA graph of the
decode step (``serving/engine.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --real-engine --queries 8
    PYTHONPATH=src python -m repro_torch.launch.serve --real-engine \\
        --arch qwen3-8b --queries 8     # or any id of configs.ARCH_IDS
                                        # or configs.PORT_IDS
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
        --real-engine --queries 3
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from ..compat import resolve_device
from ..configs import ARCH_IDS, PORT_IDS, get_config
from ..core import paper_problem
from ..models import init_params, reduced
from ..queueing_sim import ALL_DISCIPLINES, generate_stream, pk_prediction
from ..serving import DecodeEngine, LLMServer, ServerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--lam", type=float, default=0.1)
    ap.add_argument("--alpha", type=float, default=30.0)
    ap.add_argument("--discipline", default="fifo", choices=ALL_DISCIPLINES)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--online", action="store_true")
    ap.add_argument("--real-engine", action="store_true")
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=ARCH_IDS + PORT_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer, d_model 256, f32 variant (CPU tests)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    prob = paper_problem(lam=args.lam, alpha=args.alpha)
    stream = generate_stream(prob.tasks, args.lam, args.queries,
                             seed=args.seed)
    engine = None
    scfg = ServerConfig(discipline=args.discipline,
                        batch_size=args.batch_size,
                        online_adaptation=args.online,
                        generate_tokens=args.real_engine)
    if args.real_engine:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduced(cfg)
        params = init_params(cfg, seed=args.seed,
                             device=resolve_device(args.device))
        engine = DecodeEngine(cfg, params, cache_capacity=2048)
    srv = LLMServer(prob, scfg, engine=engine)
    sol = srv.allocator.solution
    print("allocation:", dict(zip(prob.tasks.names,
                                  sol.lengths_int.astype(int).tolist())))
    print("J(l*) =", round(sol.value_cont, 4),
          "| J_int =", round(sol.value_int, 4),
          "| J_bar =", round(sol.value_lower_bound, 4))
    rep = srv.run(stream)
    pred = pk_prediction(prob, list(sol.lengths_int))
    out = {
        "n": rep.n,
        "mean_wait": rep.mean_wait,
        "mean_system_time": rep.mean_system_time,
        "pk_predicted_system_time": pred["mean_system_time"],
        "p99_system_time": rep.p99_system_time,
        "utilization": rep.utilization,
        "accuracy_realized": rep.accuracy,
        "accuracy_model": rep.mean_accuracy_prob,
        "objective": rep.objective,
        "per_task_budget": rep.per_task_budget,
        "tokens_generated": rep.tokens_generated,
        "allocator_resolves": rep.n_resolves,
    }
    print(json.dumps(out, indent=2))
    return dataclasses.asdict(rep)


if __name__ == "__main__":
    main()
