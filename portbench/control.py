"""The readings of a cell's compared numbers, for setting its limits: run
on the card, not by the benchmark's own runs.

    python3 portbench/control.py --workload <cell> --seeds 11 12 ... \
        --control-seeds 3 --fault-seeds 91 92 93 --seconds 10 \
        [--out chiprun_out/control.jsonl]

Each seed is a whole run of the cell at its own load with a short window,
in this one process. The first ``--control-seeds`` of ``--seeds`` put the
control in the program's place (the reference with float8 e4m3 linear
layers, ``prec="fp8"``): their ``correct`` is the control's, and has to
be false. Each ``--fault-seeds`` run serves with a token altered where it
is produced (every request's fourth). Every line gives ``correct``, the
numbers compared with their limits, and, for the program, the control and
plain bfloat16 rounding at the same positions, the count of positions and
every gap above 0.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


@contextlib.contextmanager
def token_altered():
    """The program's fourth token of every request, one id higher."""
    import torch
    from repro_torch.serving import continuous
    cls = continuous.ContinuousBatchingEngine
    orig = cls._next_tokens

    def altered(self, logits, rids, gidx):
        out = orig(self, logits, rids, gidx)
        return torch.where(gidx == 3, (out + 1) % logits.shape[-1], out)
    cls._next_tokens = altered
    try:
        yield
    finally:
        cls._next_tokens = orig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from portbench import harness
    out = open(args.out, "a") if args.out else None
    runs = [(s, "control" if i < args.control_seeds else "program")
            for i, s in enumerate(args.seeds)]
    runs += [(s, "fault") for s in args.fault_seeds]
    for seed, side in runs:
        t = time.perf_counter()
        with token_altered() if side == "fault" else contextlib.nullcontext():
            res, _ = harness.run(args.workload, seed, args.seconds, False,
                                 t_process=t, control=side == "control",
                                 probe=True)
        line = {"workload": args.workload, "seed": seed, "side": side,
                "correct": res["correct"], "checks": res["checks"],
                "readings": {k: v for k, v in res["notes"].items()
                             if k in ("sampled_tokens", "program", "gaps",
                                      "reference_s")},
                "metrics": res["metrics"], "device": res["device"],
                "run_s": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
