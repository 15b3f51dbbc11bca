"""RWKV6 ("Finch") block: data-dependent decay linear attention.

The port of ``repro.models.rwkv6``. Time-mix recurrence per head (hd
channels, state S in R^{hd x hd}):

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)

with the data-dependent decay w_t = exp(-exp(w0 + LoRA(x_t))) in (0, 1)
and the bonus u for the current token. Prefill (any batch: the
continuous engine admits groups of equal-length prompts, one final state
per row) runs the wkv scan through ``kernels.ops.rwkv6_scan`` (the Hopper
kernel on a CUDA device, its plain version on the CPU). The reference path
(``force_ref``: the trainer, the dry-run's counts, the sharded path) runs
:func:`wkv_chunked`, the JAX model's own chunked wkv (chunks of 128
tokens, halved until they divide S), in f32 and differentiable by
autograd; the kernel computes the same function. Decode is the one-token
recurrence, as in the JAX package (no TPU kernel exists for it). Channel
mix is the squared-ReLU FFN with token shift. ``w0`` and ``u`` stay f32
in a bf16 model.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..compat import acc, is_dtensor
from ..kernels import ops as kops
from ..roofline.analysis import count_as
from .config import ModelConfig
from .layers import _he, on_local_heads
from .mamba2 import carry_chunks, chunk_len

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


#: the JAX model's wkv chunk length (``repro.models.rwkv6``)
WKV_CHUNK = 128


def _wkv_chunked(r: Tensor, k: Tensor, v: Tensor, la: Tensor, u: Tensor,
                 chunk: int):
    B, S, nh, hd = r.shape
    Q = chunk_len(S, chunk)
    nC = S // Q
    rq, kq, vq, laq = (acc(t).reshape(B, nC, Q, nh, hd)
                       for t in (r, k, v, la))
    cs = torch.cumsum(laq, dim=2)                       # inclusive
    # intra-chunk, strictly lower (the state BEFORE the current token):
    # y_i += sum_{j<i} (r_i exp(cs_i - la_i - cs_j) . k_j) v_j
    ri = rq * torch.exp(cs - laq)
    kj = kq * torch.exp(-cs)
    att = torch.einsum("bciht,bcjht->bchij", ri, kj)    # [B,c,nh,Qi,Qj]
    strict = torch.ones(Q, Q, dtype=torch.bool, device=r.device).tril(-1)
    att = torch.where(strict, att, torch.zeros((), dtype=att.dtype,
                                                device=r.device))
    y = torch.einsum("bchij,bcjht->bciht", att, vq)
    # the bonus on the diagonal: y_i += (r_i . (u * k_i)) v_i
    y = y + (rq * acc(u) * kq).sum(-1, keepdim=True) * vq
    # each chunk's state contribution, decayed to the chunk's end, and the
    # state carried across them (carry_chunks)
    kst = kq * torch.exp(cs[:, :, -1:] - cs)
    chunk_state = torch.einsum("bcjht,bcjhu->bchtu", kst[:, :-1],
                               vq[:, :-1])
    chunk_decay = torch.exp(cs[:, :, -1])[..., None]    # [B,c,nh,hd,1]
    entering, s = carry_chunks(
        chunk_decay, chunk_state,
        lambda k, v: torch.einsum("bjht,bjhu->bhtu", k, v),
        (kst[:, -1], vq[:, -1]))
    y = y + torch.einsum("bciht,bchtu->bcihu", ri, entering)
    return y.reshape(B, S, nh, hd), s


def wkv_chunked(r: Tensor, k: Tensor, v: Tensor, la: Tensor, u: Tensor,
                chunk: int = WKV_CHUNK):
    """The JAX model's chunked wkv (``repro.models.rwkv6.rwkv6_time_mix``)
    in ``kernels.ops.rwkv6_scan``'s model layout: r, k, v [B,S,nh,hd]; la
    [B,S,nh,hd] f32 log decays; u [nh,hd] f32 -> (y [B,S,nh,hd] and
    s_final [B,nh,hd,hd], f32; f64 for f64 inputs). Chunks of
    :func:`~.mamba2.chunk_len` tokens; the decays in the JAX model's
    arrangement (r_i exp(cs_i - la_i), k_j exp(-cs_j), cs the inclusive
    cumulative log decay within the chunk), the strictly lower
    intra-chunk triangle plus the bonus, then the state carried across
    the chunk summaries. Plain PyTorch, differentiable by autograd.
    Counted as the sequential oracle (``kernels.ref.rwkv_scan_ref``) at
    the same shapes: 2 hd^2 FLOPs a token and head in its one product
    (y_t = r_t (S + u k_t v_t)), and the backward's one per operand that
    needs a gradient (r, and the state if k, v, la or u do)."""
    B, S, nh, hd = r.shape
    fwd = 2 * B * nh * S * hd * hd
    grads = r.requires_grad + any(t.requires_grad for t in (k, v, la, u))
    return count_as(_wkv_chunked, (r, k, v, la, u, chunk), fwd,
                    fwd * grads)


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
    args = (r, k, v, la, p["u"])
    sharded = None
    if force_ref and is_dtensor(r):   # sharded: per rank's heads
        sharded = on_local_heads(wkv_chunked, args, (0, 0, 0, 0, None),
                                 (2, 2, 2, 2, 0), ((0, 2), (0, 1)))
    if sharded is not None:
        y, s_final = sharded
    elif force_ref:
        y, s_final = wkv_chunked(*args)
    else:
        y, s_final = kops.rwkv6_scan(*args)
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
