"""RWKV6 ("Finch") block: data-dependent decay linear attention.

The port of ``repro.models.rwkv6``. Time-mix recurrence per head (hd
channels, state S in R^{hd x hd}):

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)

with the data-dependent decay w_t = exp(-exp(w0 + LoRA(x_t))) in (0, 1)
and the bonus u for the current token. Prefill (any batch: the
continuous engine admits groups of equal-length prompts, one final state
per row) runs the wkv scan through
``kernels.ops.rwkv6_scan`` (the Hopper kernel on a CUDA device, its plain
version on the CPU, the sequential oracle under ``force_ref``) where the
JAX package ran its own jnp chunked scan; both compute the same function.
Decode is the one-token recurrence, as in the JAX package (no TPU kernel
exists for it). Channel mix is the squared-ReLU FFN with token shift.
``w0`` and ``u`` stay f32 in a bf16 model.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..compat import acc
from ..kernels import ops as kops
from .config import ModelConfig
from .layers import _he

Tensor = torch.Tensor


class RWKVCache(NamedTuple):
    """Recurrent decode state; the model stacks each leaf on leading layer
    axes (``[L, ...]``) and updates it in place."""

    shift_tm: Tensor   # [..., B, d] previous token (time mix)
    shift_cm: Tensor   # [..., B, d] previous token (channel mix)
    wkv: Tensor        # [..., B, nh, hd, hd] f32 state
    length: int        # tokens seen, host bookkeeping: no decode op reads
                       # it, and a replayed CUDA graph step does not advance it


def dims(cfg: ModelConfig):
    hd = cfg.rwkv.head_dim
    return cfg.d_model // hd, hd


def init_rwkv6(cfg: ModelConfig, gen: torch.Generator, lead: tuple) -> dict:
    d, f, r = cfg.d_model, cfg.d_ff, cfg.rwkv.decay_lora
    nh, hd = dims(cfg)
    dt, dev = cfg.tdtype, gen.device

    def full(shape, value, dtype=dt):
        return torch.full(lead + shape, value, dtype=dtype, device=dev)
    return {
        # time-mix interpolation coefficients for r, k, v, w, g
        "mu": full((5, d), 0.5),
        "wr": _he(gen, lead + (d, d), dt, fan_in=d),
        "wk": _he(gen, lead + (d, d), dt, fan_in=d),
        "wv": _he(gen, lead + (d, d), dt, fan_in=d),
        "wg": _he(gen, lead + (d, d), dt, fan_in=d),
        "wo": _he(gen, lead + (d, d), dt, fan_in=d),
        # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x A) B))
        "w0": full((d,), -4.0, torch.float32),
        "wA": _he(gen, lead + (d, r), dt, fan_in=d),
        "wB": _he(gen, lead + (r, d), dt, fan_in=r),
        "u": full((nh, hd), 0.1, torch.float32),
        "ln_x": full((d,), 1.0),             # per-head group norm scale
        # channel mix
        "mu_cm": full((2, d), 0.5),
        "ck": _he(gen, lead + (d, f), dt, fan_in=d),
        "cv": _he(gen, lead + (f, d), dt, fan_in=f),
        "cr": _he(gen, lead + (d, d), dt, fan_in=d),
    }


def _mix(x: Tensor, prev: Tensor, mu: Tensor) -> Tensor:
    return x + (prev - x) * mu


def _decay(p: dict, xw: Tensor) -> Tensor:
    """log decay la = -exp(w0 + tanh(xw A) B), elementwise < 0, f32."""
    lora = acc(torch.matmul(torch.tanh(acc(torch.matmul(xw, p["wA"])))
                            .to(xw.dtype), p["wB"]))
    return -torch.exp(torch.clamp(p["w0"] + lora, -20.0, 8.0))


def _group_norm(p: dict, y: Tensor, nh: int, hd: int) -> Tensor:
    """Per-head RMS normalization of the wkv output, f32."""
    yf = acc(y)
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6)
    yf = yf.reshape(yf.shape[:-2] + (nh * hd,))
    return yf * acc(p["ln_x"])


def rwkv6_time_mix(cfg: ModelConfig, p: dict, x: Tensor, prev: Tensor,
                   force_ref: bool = False):
    """x [B,S,d], prev [B,d] (token before the window).

    Returns (y [B,S,d], last_state [B,nh,hd,hd] f32, last_token [B,d]).
    """
    B, S, d = x.shape
    nh, hd = dims(cfg)
    xx = torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)
    xr = _mix(x, xx, p["mu"][0])
    xk = _mix(x, xx, p["mu"][1])
    xv = _mix(x, xx, p["mu"][2])
    xw = _mix(x, xx, p["mu"][3])
    xg = _mix(x, xx, p["mu"][4])
    r = torch.matmul(xr, p["wr"]).reshape(B, S, nh, hd)
    k = torch.matmul(xk, p["wk"]).reshape(B, S, nh, hd)
    v = torch.matmul(xv, p["wv"]).reshape(B, S, nh, hd)
    g = torch.matmul(xg, p["wg"])
    la = _decay(p, xw).reshape(B, S, nh, hd)            # log decay, f32
    y, s_final = kops.rwkv6_scan(r, k, v, la, p["u"], force_ref=force_ref)
    y = _group_norm(p, y, nh, hd).reshape(B, S, d)
    y = y * torch.nn.functional.silu(acc(g))
    out = torch.matmul(y.to(x.dtype), p["wo"])
    return out, s_final, x[:, -1, :]


def rwkv6_channel_mix(cfg: ModelConfig, p: dict, x: Tensor, prev: Tensor):
    xx = torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)
    xk = _mix(x, xx, p["mu_cm"][0])
    xr = _mix(x, xx, p["mu_cm"][1])
    k = torch.matmul(xk, p["ck"])
    k = torch.square(torch.relu(acc(k))).to(x.dtype)
    kv = torch.matmul(k, p["cv"])
    rgate = torch.sigmoid(acc(torch.matmul(xr, p["cr"]))).to(x.dtype)
    return rgate * kv, x[:, -1, :]


def init_rwkv_cache(cfg: ModelConfig, batch: int, device,
                    lead: tuple = ()) -> RWKVCache:
    """Zeroed recurrent state at length 0, leaves stacked on ``lead``."""
    nh, hd = dims(cfg)
    return RWKVCache(
        shift_tm=torch.zeros(lead + (batch, cfg.d_model), dtype=cfg.tdtype,
                             device=device),
        shift_cm=torch.zeros(lead + (batch, cfg.d_model), dtype=cfg.tdtype,
                             device=device),
        wkv=torch.zeros(lead + (batch, nh, hd, hd), dtype=torch.float32,
                        device=device),
        length=0)


def rwkv6_time_mix_decode(cfg: ModelConfig, p: dict, x1: Tensor,
                          state: Tensor, prev: Tensor):
    """x1 [B,d] single token; state [B,nh,hd,hd]; prev [B,d].
    Returns (y [B,d], next state, the new shift token)."""
    B, d = x1.shape
    nh, hd = dims(cfg)
    xr = _mix(x1, prev, p["mu"][0])
    xk = _mix(x1, prev, p["mu"][1])
    xv = _mix(x1, prev, p["mu"][2])
    xw = _mix(x1, prev, p["mu"][3])
    xg = _mix(x1, prev, p["mu"][4])
    r = torch.matmul(xr, p["wr"]).reshape(B, nh, hd)
    k = torch.matmul(xk, p["wk"]).reshape(B, nh, hd)
    v = torch.matmul(xv, p["wv"]).reshape(B, nh, hd)
    g = torch.matmul(xg, p["wg"])
    w = torch.exp(_decay(p, xw).reshape(B, nh, hd))    # decay in (0, 1)
    rf, kf, vf = acc(r), acc(k), acc(v)
    kv = torch.einsum("bht,bhu->bhtu", kf, vf)
    att = state + p["u"][None, :, :, None] * kv
    y = torch.einsum("bht,bhtu->bhu", rf, att)
    s_next = w[..., None] * state + kv
    y = _group_norm(p, y, nh, hd).reshape(B, d)
    y = y * torch.nn.functional.silu(acc(g))
    out = torch.matmul(y.to(x1.dtype), p["wo"])
    return out, s_next, x1


def rwkv6_channel_mix_decode(cfg: ModelConfig, p: dict, x1: Tensor,
                             prev: Tensor):
    xk = _mix(x1, prev, p["mu_cm"][0])
    xr = _mix(x1, prev, p["mu_cm"][1])
    k = torch.matmul(xk, p["ck"])
    k = torch.square(torch.relu(acc(k))).to(x1.dtype)
    kv = torch.matmul(k, p["cv"])
    rgate = torch.sigmoid(acc(torch.matmul(xr, p["cr"]))).to(x1.dtype)
    return rgate * kv, x1
