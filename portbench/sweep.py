"""The knee of a ``poisson`` cell: one sweep of offered rates on the card.

    python3 portbench/sweep.py --workload <cell> --seed <n> \
        --rates 2 3 4 5 6 --warm 10 --seconds 20

One process builds the cell's weights and engine once and, for each rate
in turn, runs the open loop for ``--warm`` seconds and then ``--seconds``
measured ones, prints the admission queue at the window's open and close
and its least-squares slope over the window, the rate of requests
finished and the cell's end-to-end metrics, and drains the engine before
the next rate. The knee is the highest rate at which the requests in
the system (queued and in rows) do not grow across the window.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def slope(points) -> float:
    n = len(points)
    if n < 2:
        return 0.0
    mt = sum(t for t, _ in points) / n
    mq = sum(q for _, q in points) / n
    var = sum((t - mt) ** 2 for t, _ in points)
    return sum((t - mt) * (q - mq) for t, q in points) / var if var else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--warm", type=float, default=10.0)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    import torch
    from portbench import harness, loop, stats, traffic, weights
    from repro_torch.core.allocator import TokenBudgetAllocator
    from repro_torch.serving.continuous import ContinuousBatchingEngine
    from repro_torch.serving.request import Request as PortRequest
    from repro_torch.serving.scheduler import Scheduler
    import importlib
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    f = harness.find(bench, args.workload)
    spec, mix, cell = f["spec"], f["mix"], f["cell"]
    family = importlib.import_module(f"portbench.families.{spec['family']}")
    cfg = family.port_config(spec)
    dev = torch.device("cuda")
    params = weights.build(family.leaves(spec), spec["num_hidden_layers"],
                           args.seed, cfg.tdtype, dev)
    engine = ContinuousBatchingEngine(cfg, params, **cell["engine"])
    harness._warm_shapes(engine, mix)
    for rate in args.rates:
        n = int(rate * (args.warm + args.seconds) * 1.3) + 10
        reqs = traffic.generate(mix, n, args.seed, spec["vocab_size"], rate)
        by_rid = {r.rid: r for r in reqs}
        sched = Scheduler(TokenBudgetAllocator(harness.problem(mix)))
        ol = loop.OpenLoop(
            engine, sched, reqs,
            lambda r: PortRequest(rid=r.rid, task_index=r.task,
                                  prompt=r.prompt, arrival_t=r.due,
                                  max_extra_tokens=r.max_extra),
            time.perf_counter())
        t_open, t_close = args.warm, args.warm + args.seconds
        ol.run_until(t_close, by_rid)
        q = [(t, x) for t, x, _ in ol.queue_len if t_open <= t < t_close]
        held = [(t, x + n) for t, x, n in ol.queue_len
                if t_open <= t < t_close]
        due = stats.due_in(reqs, t_open, t_close)
        line = {"workload": args.workload, "rate": rate,
                "due_in_window": len(due),
                "finished_per_s": sum(r.done and t_open <= r.last_read
                                      < t_close for r in reqs)
                / args.seconds,
                "queue_open": q[0][1] if q else None,
                "queue_close": q[-1][1] if q else None,
                "queue_slope_per_s": slope(q),
                "in_system_open": held[0][1] if held else None,
                "in_system_close": held[-1][1] if held else None,
                "in_system_slope_per_s": slope(held),
                "live_mean": stats.mean(len(c.rows) for c in ol.chunks
                                        if t_open <= c.start < t_close),
                **stats.poisson_metrics(reqs, t_open, t_close),
                "tokens_per_s": stats.tokens_per_s(reqs, t_open, t_close)}
        print(json.dumps(line), flush=True)
        ol.pending.clear()
        while ol.queued():               # drop the queue, drain the rows
            ol._next()
        while engine.n_active:
            engine.step_chunk()
    return 0


if __name__ == "__main__":
    sys.exit(main())
