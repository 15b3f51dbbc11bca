"""Helpers of the readers of the engine's phase spans (the port's
``serving/continuous.py``): the stats span after a parent span, and the
fused FFN's least time from the MoE's routing counts that it carries.

Where the program records none of these spans or arguments, each reader
finds nothing and returns None.
"""
from __future__ import annotations

from . import roofline

#: the kernels of ``csrc/fused_ffn.cu``, as the profiler names them
FFN_KERNELS = ("ffn_gemm", "ffn_partial", "ffn_reduce")


def within(ctx, name: str, t0: float, t1: float) -> list:
    """The port's wall spans ``name`` that lie inside ``[t0, t1]``."""
    return [s for s in ctx.spans if s[0] == name and t0 <= s[1]
            and s[2] <= t1]


def after(ctx, name: str, parent) -> dict | None:
    """The args of the span ``name`` that the engine records right after
    ``parent`` (a span tuple): the first of its kind to start after the
    parent does, unless another span of the parent's name starts first.
    None where there is none."""
    later = sorted((s for s in ctx.spans if s[1] > parent[1]
                    and s[0] in (name, parent[0])), key=lambda s: s[1])
    return later[0][3] if later and later[0][0] == name else None


def ffn_cost(spec: dict, experts_hit: int, pairs: int, rows: int,
             layer_steps: int) -> tuple:
    """(FLOPs, bytes) of the fused FFN over the MoE layers of a prefill or
    of a decode chunk: ``pairs`` routed (token, expert) pairs computed and
    ``rows`` tokens through the shared experts, summed over the layers
    (and steps); the weights of the ``experts_hit`` (layer, step, expert)
    triples read once, the shared experts' weights once in each of the
    ``layer_steps``; each pair's and each row's input read and output
    written once."""
    d, f = spec["hidden_size"], spec["moe_intermediate_size"]
    expert = 3 * d * f                       # gate, up and down
    shared = expert * spec["n_shared_experts"]
    flops = 2.0 * (pairs * expert + rows * shared)
    nbytes = roofline.BF16 * (experts_hit * expert + layer_steps * shared
                              + 2 * d * (pairs + rows))
    return flops, nbytes


def ffn_time(sl, t0: float, t1: float) -> float:
    """The profiler's time of the fused FFN's kernels inside ``[t0, t1]``."""
    return sum(sl.kernel_time(k, t0, t1) for k in FFN_KERNELS)
