"""The benchmark's own yardstick: H100 peaks, and the operations and bytes
that a model's work needs, counted from the configuration's published
shapes (the keys of ``configs/<name>.json``), whatever kernel does it.

Kept apart from the program's ``roofline/analysis.py`` so that no change
to the program moves it. Each count is of what the inputs need: every
input byte read once, every output byte written once, the matmuls of the
experts a token is routed to, and the logits of the positions that are
sampled.
"""
from __future__ import annotations

import subprocess

#: NVIDIA H100 SXM data sheet, dense bf16 tensor-core rate and HBM3
PEAK_BF16_FLOPS = 989.4e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2


def head_dim(spec: dict) -> int:
    return int(spec.get("head_dim")
               or spec["hidden_size"] // spec["num_attention_heads"])


def kv_bytes_per_token(spec: dict) -> int:
    """K and V of one position over every layer, in bf16."""
    return (spec["num_hidden_layers"] * 2 * spec["num_key_value_heads"]
            * head_dim(spec) * BF16)


def layer_matmul_params(spec: dict) -> int:
    """Weights one token multiplies through in one MoE layer: q, k, v, o,
    the router, its top-k routed experts and the shared experts."""
    d, hd = spec["hidden_size"], head_dim(spec)
    nh, nkv = spec["num_attention_heads"], spec["num_key_value_heads"]
    attn = d * (nh + 2 * nkv) * hd + nh * hd * d
    experts = (spec["num_experts_per_tok"] + spec["n_shared_experts"]) \
        * 3 * d * spec["moe_intermediate_size"]
    return attn + d * spec["n_routed_experts"] + experts


def attention_flops(spec: dict, pairs: int) -> float:
    """Scores and the weighted sum over ``pairs`` (query, key) pairs in
    one layer."""
    return 4.0 * spec["num_attention_heads"] * head_dim(spec) * pairs


def head_flops(spec: dict) -> float:
    return 2.0 * spec["hidden_size"] * spec["vocab_size"]


def decode_token_flops(spec: dict, ctx: int) -> float:
    """One decoded token that attends ``ctx`` positions (itself included)."""
    L = spec["num_hidden_layers"]
    return (2.0 * layer_matmul_params(spec) * L
            + L * attention_flops(spec, ctx) + head_flops(spec))


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def prefill_flops(spec: dict, S: int) -> float:
    """A prompt of ``S`` tokens, causal, and the logits of its last one."""
    L = spec["num_hidden_layers"]
    return (2.0 * layer_matmul_params(spec) * L * S
            + L * attention_flops(spec, causal_pairs(S)) + head_flops(spec))


def flash_cost(spec: dict, S: int) -> tuple:
    """(FLOPs, bytes) of causal prefill attention over ``S`` tokens in
    every layer: scores and sum over the causal pairs; q, k, v read and
    the output written once."""
    L, hd = spec["num_hidden_layers"], head_dim(spec)
    nh, nkv = spec["num_attention_heads"], spec["num_key_value_heads"]
    flops = L * attention_flops(spec, causal_pairs(S))
    nbytes = L * S * hd * (2 * nh + 2 * nkv) * BF16
    return flops, nbytes


def decode_attention_cost(spec: dict, ctxs) -> tuple:
    """(FLOPs, bytes) of one decode step's attention in every layer over
    rows that attend ``ctxs`` positions each: their cached K/V read once,
    q read and the output written once per row."""
    L, hd = spec["num_hidden_layers"], head_dim(spec)
    nh, nkv = spec["num_attention_heads"], spec["num_key_value_heads"]
    total = sum(ctxs)
    flops = L * attention_flops(spec, total)
    nbytes = L * (total * 2 * nkv * hd + len(ctxs) * 2 * nh * hd) * BF16
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def card() -> dict:
    """The card's name, power limit and SM clock, as ``nvidia-smi`` reads
    them (empty where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.strip().splitlines()[0]
        name, limit, clock = (x.strip() for x in out.split(","))
        return {"card": name, "power_limit_w": float(limit),
                "sm_clock_mhz": float(clock)}
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return {}
