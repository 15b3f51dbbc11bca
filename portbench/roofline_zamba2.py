"""The benchmark's yardstick for the ``zamba2`` family (Zamba2 as
published): the operations and bytes of its decode step, counted from
the configuration file's published shapes, whatever kernel does the
work. Only the H100's peaks come from ``roofline.py``.

Counted as ``roofline.py`` counts: every weight a token multiplies
through, once; every input byte read and every output byte written once
(weights and caches in bf16, the SSD state in f32).
"""
from __future__ import annotations

from .roofline import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

BF16, F32 = 2, 4


def mamba_dims(spec: dict) -> tuple:
    """(d_in, SSD heads, head dim, state size, B/C width over the groups,
    conv width)."""
    d_in = spec["mamba_expand"] * spec["hidden_size"]
    return (d_in, spec["n_mamba_heads"], spec["mamba_headdim"],
            spec["mamba_d_state"],
            2 * spec["mamba_ngroups"] * spec["mamba_d_state"],
            spec["mamba_d_conv"])


def mamba_matmul_params(spec: dict) -> int:
    """One Mamba2 layer's projections: in (z, x, B/C, dt) and out."""
    d = spec["hidden_size"]
    d_in, nh, _, _, bc, _ = mamba_dims(spec)
    return d * (2 * d_in + bc + nh) + d_in * d


def mamba_weight_bytes(spec: dict) -> int:
    """Every weight of the Mamba2 layers: projections, conv taps and
    biases, A_log, D, dt_bias, the gated norm's and the input norm's
    scales."""
    d_in, nh, _, _, bc, K = mamba_dims(spec)
    per = (mamba_matmul_params(spec) + (K + 1) * (d_in + bc) + 3 * nh
           + d_in + spec["hidden_size"])
    return spec["num_hidden_layers"] * per * BF16


def state_bytes_per_row(spec: dict) -> int:
    """One row's recurrent state over every layer: the f32 SSD state and
    the conv's trailing inputs."""
    d_in, nh, hd, ds, bc, K = mamba_dims(spec)
    return spec["num_hidden_layers"] * (nh * hd * ds * F32
                                        + (K - 1) * (d_in + bc) * BF16)


def mamba_step_bytes(spec: dict, rows: int) -> int:
    """A decode step's Mamba2 layers: their weights once, and every row's
    state read and written once."""
    return mamba_weight_bytes(spec) + 2 * rows * state_bytes_per_row(spec)


def mamba_step_flops(spec: dict, rows: int) -> float:
    """A decode step's Mamba2 layers over ``rows``: projections, conv,
    and the SSD's product ``y = S C`` (2 hd ds a head, as the port's
    counter counts the scan)."""
    d_in, nh, hd, ds, bc, K = mamba_dims(spec)
    per = 2.0 * (mamba_matmul_params(spec) + K * (d_in + bc) + nh * hd * ds)
    return rows * spec["num_hidden_layers"] * per


def n_apps(spec: dict) -> int:
    return len(spec["hybrid_layer_ids"])


def shared_app_params(spec: dict) -> int:
    """Weights a token multiplies through in one shared application:
    q, k, v over [h, x0], o, gate_up, down, the adapter and the linear."""
    d, f, r = (spec["hidden_size"], spec["intermediate_size"],
               spec["adapter_rank"])
    nh, nkv = spec["num_attention_heads"], spec["num_key_value_heads"]
    hd = spec["attention_head_dim"]
    return (2 * d * (nh + 2 * nkv) * hd + nh * hd * d + 3 * d * f
            + r * (d + 2 * f) + d * d)


def attention_flops_per_position(spec: dict) -> float:
    """Scores and weighted sum over one cached position, every
    application."""
    return 4.0 * n_apps(spec) * spec["num_attention_heads"] \
        * spec["attention_head_dim"]


def kv_bytes_per_position(spec: dict) -> int:
    """K and V of one position over every application, in bf16."""
    return (n_apps(spec) * 2 * spec["num_key_value_heads"]
            * spec["attention_head_dim"] * BF16)


def decode_token_flops(spec: dict, ctx: int) -> float:
    """One decoded token that attends ``ctx`` positions (itself
    included): the Mamba2 layers, the shared applications, attention
    over its positions, the tied head."""
    return (mamba_step_flops(spec, 1)
            + 2.0 * n_apps(spec) * shared_app_params(spec)
            + attention_flops_per_position(spec) * ctx
            + 2.0 * spec["hidden_size"] * spec["vocab_size"])


def decode_attention_cost(spec: dict, ctxs) -> tuple:
    """(FLOPs, bytes) of one decode step's shared attention in every
    application over rows that attend ``ctxs`` positions each: their
    cached K/V read once, q read and the output written once per row."""
    nh, hd = spec["num_attention_heads"], spec["attention_head_dim"]
    total = sum(ctxs)
    flops = attention_flops_per_position(spec) * total
    nbytes = (kv_bytes_per_position(spec) * total
              + n_apps(spec) * len(ctxs) * 2 * nh * hd * BF16)
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
