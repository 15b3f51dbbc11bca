"""Mamba2 block with the SSD scan.

The port of ``repro.models.mamba2``. Recurrence per head h (scalar decay
a_t = exp(A dt_t), A < 0):

    S_t = a_t S_{t-1} + dt_t x_t B_t^T        S in R^{hd x ds}
    y_t = S_t C_t + D x_t

Prefill (any batch: the continuous engine admits groups of equal-length
prompts, one final state and conv tail per row) runs the scan through
``kernels.ops.ssd_scan`` (the Hopper kernel on a CUDA device, its plain
version on the CPU). The reference path (``force_ref``: the trainer, the
dry-run's counts, the sharded path) runs :func:`ssd_chunked`, the JAX
model's own chunked SSD (chunks of ``cfg.ssm.chunk`` tokens, halved until
they divide S), in f32 with the JAX model's roundings and differentiable
by autograd; the kernel computes the same function. ``D x`` stays outside
the scan. Decode is the single-step recurrence against a
``[B, nh, hd, ds]`` state. ``A_log``, ``D`` and ``dt_bias`` stay f32 in a
bf16 model.

Grouped B/C (``cfg.ssm.n_groups`` = g > 1, Zamba2 as published): the
projections and the conv carry g rows of B and g of C (``[B_0 .. B_g-1,
C_0 .. C_g-1]``), heads ``[j nh / g, (j + 1) nh / g)`` read group j's,
the scan runs once per group over its heads, and the gated norm
normalises each group's ``d_in / g`` channels on its own. A config's
``dt_min`` floors the step size after the softplus.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..compat import acc, is_dtensor
from ..kernels import ops as kops
from ..roofline.analysis import count_as
from .config import ModelConfig
from .layers import _he, on_local_heads

Tensor = torch.Tensor


class MambaCache(NamedTuple):
    """Recurrent decode state; the model stacks each leaf on leading layer
    axes and updates it in place."""

    conv_x: Tensor   # [..., B, d_conv - 1, d_in]  trailing conv inputs
    conv_bc: Tensor  # [..., B, d_conv - 1, 2*g*ds]  trailing B/C conv inputs
    ssd: Tensor      # [..., B, nh, hd, ds] f32 recurrent state
    length: int      # tokens seen, host bookkeeping: no decode op reads
                     # it, and a replayed CUDA graph step does not advance it


def dims(cfg: ModelConfig):
    d_in = cfg.ssm.expand * cfg.d_model
    return d_in, d_in // cfg.ssm.head_dim, cfg.ssm.head_dim, cfg.ssm.d_state


def init_mamba2(cfg: ModelConfig, gen: torch.Generator, lead: tuple) -> dict:
    d, K = cfg.d_model, cfg.ssm.d_conv
    d_in, nh, hd, _ = dims(cfg)
    ds = cfg.ssm.n_groups * cfg.ssm.d_state     # B (or C) of every group
    dt, dev = cfg.tdtype, gen.device

    def full(shape, value, dtype=dt):
        return torch.full(lead + shape, value, dtype=dtype, device=dev)
    return {
        "z_proj": _he(gen, lead + (d, d_in), dt, fan_in=d),
        "x_proj": _he(gen, lead + (d, d_in), dt, fan_in=d),
        "bc_proj": _he(gen, lead + (d, 2 * ds), dt, fan_in=d),
        "dt_proj": _he(gen, lead + (d, nh), dt, fan_in=d),
        "conv_x": _he(gen, lead + (K, d_in), dt, fan_in=K),
        "conv_bc": _he(gen, lead + (K, 2 * ds), dt, fan_in=K),
        "conv_b_x": full((d_in,), 0.0),
        "conv_b_bc": full((2 * ds,), 0.0),
        "A_log": full((nh,), 0.0, torch.float32),      # A = -exp(A_log)
        "D": full((nh,), 1.0, torch.float32),
        "dt_bias": full((nh,), -2.0, torch.float32),
        "norm": full((d_in,), 1.0),
        "out_proj": _he(gen, lead + (d_in, d), dt, fan_in=d_in),
    }


def _split_proj(cfg: ModelConfig, p: dict, x: Tensor):
    ds = cfg.ssm.n_groups * cfg.ssm.d_state
    z = torch.matmul(x, p["z_proj"])
    xi = torch.matmul(x, p["x_proj"])
    bc = torch.matmul(x, p["bc_proj"])
    dt = torch.matmul(x, p["dt_proj"])
    return z, xi, bc[..., :ds], bc[..., ds:], dt


def _conv_full(w: Tensor, b: Tensor, u: Tensor) -> Tensor:
    """Causal depthwise conv over [B,S,C] with width K, then silu."""
    K, S = w.shape[0], u.shape[1]
    pad = torch.nn.functional.pad(u, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(K))
    return torch.nn.functional.silu((out + b).float()).to(u.dtype)


def _gated_norm(cfg: ModelConfig, p: dict, y: Tensor, z: Tensor) -> Tensor:
    yf = (y * torch.nn.functional.silu(z.float()).to(y.dtype)).float()
    g = cfg.ssm.n_groups
    if g > 1:                       # each group's channels on their own
        yf = yf.unflatten(-1, (g, -1))
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True)
                          + cfg.norm_eps)
    return (yf.flatten(-2) if g > 1 else yf).mul(
        p["norm"].float()).to(y.dtype)


def _step_size(cfg: ModelConfig, p: dict, dt: Tensor) -> Tensor:
    """softplus(dt + dt_bias) in f32, floored at the config's ``dt_min``."""
    dt = torch.nn.functional.softplus(dt.float() + p["dt_bias"])
    return dt.clamp(min=cfg.ssm.dt_min) if cfg.ssm.dt_min > 0 else dt


def _per_group(fn, g: int, x: Tensor, dt: Tensor, la: Tensor, Bm: Tensor,
               Cm: Tensor):
    """``fn(x, dt, la, Bm, Cm)`` (a scan whose B/C rows ``[B, S, ds]`` are
    shared by its heads) once per group over the group's heads, ``Bm`` /
    ``Cm`` ``[B, S, g * ds]``: (y [B, S, nh, hd], s_final [B, nh, hd, ds])
    with the groups' heads in order."""
    if g == 1:
        return fn(x, dt, la, Bm, Cm)
    r, ds = x.shape[2] // g, Bm.shape[-1] // g
    outs = [fn(x[:, :, j * r:(j + 1) * r], dt[..., j * r:(j + 1) * r],
               la[..., j * r:(j + 1) * r], Bm[..., j * ds:(j + 1) * ds],
               Cm[..., j * ds:(j + 1) * ds]) for j in range(g)]
    return (torch.cat([o[0] for o in outs], dim=2),
            torch.cat([o[1] for o in outs], dim=1))


def _tail(u: Tensor, n: int) -> Tensor:
    """The last ``n`` rows of [B,S,C], zero rows in front when S < n (the
    conv's own zero padding)."""
    return torch.nn.functional.pad(u, (0, 0, max(0, n - u.shape[1]), 0))[
        :, -n:]


def chunk_len(S: int, chunk: int) -> int:
    """The chunk length of an S-token scan: ``min(chunk, S)``, halved
    until it divides S (the JAX models' rule for a ragged S)."""
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    return Q


def carry_chunks(decay: Tensor, contrib: Tensor, last_contrib, last_args):
    """The state carried across a chunked scan's chunk summaries: ``decay``
    [B,nC,...] each chunk's total decay (broadcast over the state),
    ``contrib`` [B,nC-1,...] each chunk's own state contribution decayed
    to its end, but the last chunk's, which is ``last_contrib(*last_args)``
    -> (the state entering each chunk [B,nC,...], zero for the first, and
    the final state). The last chunk's summary feeds the final state only
    and is counted as the sequential oracle's state update: no matmul."""
    s = contrib.new_zeros(contrib.shape[:1] + contrib.shape[2:])
    entering = [s]
    for d, c in zip(decay.unbind(1), contrib.unbind(1)):
        s = d * s + c
        entering.append(s)

    def final(s, d, *args):
        return d * s + last_contrib(*args)
    return torch.stack(entering, dim=1), count_as(
        final, (s, decay[:, -1], *last_args), 0, 0)


def _ssd_chunked(x: Tensor, dt: Tensor, la: Tensor, Bm: Tensor, Cm: Tensor,
                 chunk: int):
    B, S, nh, hd = x.shape
    ds = Bm.shape[-1]
    Q = chunk_len(S, chunk)
    nC = S // Q
    lq = acc(la).reshape(B, nC, Q, nh)
    dq = acc(dt).reshape(B, nC, Q, nh)
    xq = acc(x).reshape(B, nC, Q, nh, hd)
    Bq = acc(Bm).reshape(B, nC, Q, ds)
    Cq = acc(Cm).reshape(B, nC, Q, ds)
    cums = torch.cumsum(lq, dim=2)                          # [B,nC,Q,nh]
    # intra-chunk decay-masked scores [B,nC,Qi,Qj,nh], rounded to x's
    # dtype as the JAX model rounds them (its dots accumulate in f32). The
    # masked (upper) entries are exp(-inf) = 0, so no overflowing exp
    # reaches the backward.
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]
    diff = torch.where(causal[:, :, None], diff,
                       torch.full((), -torch.inf, dtype=diff.dtype,
                                  device=x.device))
    cb = torch.einsum("bcis,bcjs->bcij", Cq, Bq)
    scores = acc((torch.exp(diff) * cb[..., None] * dq[:, :, None])
                 .to(x.dtype))
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xq)
    # each chunk's state contribution, decayed to the chunk's end, and the
    # state carried across them (carry_chunks)
    wx = acc((dq * torch.exp(cums[:, :, -1:] - cums)).to(x.dtype))[..., None] \
        * xq
    chunk_state = torch.einsum("bcjhp,bcjs->bchps", wx[:, :-1], Bq[:, :-1])
    chunk_decay = torch.exp(cums[:, :, -1])[..., None, None]  # [B,nC,nh,1,1]
    entering, s = carry_chunks(
        chunk_decay, chunk_state,
        lambda w, b: torch.einsum("bjhp,bjs->bhps", w, b),
        (wx[:, -1], Bq[:, -1]))
    y_inter = torch.einsum("bcis,bchps->bcihp", Cq, entering)
    y = y + y_inter * torch.exp(cums)[..., None]
    return y.reshape(B, S, nh, hd), s


def ssd_chunked(x: Tensor, dt: Tensor, la: Tensor, Bm: Tensor, Cm: Tensor,
                chunk: int):
    """The JAX model's chunked SSD (``repro.models.mamba2.mamba2_forward``)
    in ``kernels.ops.ssd_scan``'s model layout: x [B,S,nh,hd]; dt, la
    [B,S,nh] f32; Bm, Cm [B,S,ds] shared by a row's heads -> (y [B,S,nh,hd]
    and s_final [B,nh,hd,ds], f32; f64 for f64 inputs). Chunks of
    :func:`chunk_len` tokens: decay-masked intra-chunk scores for all
    chunks at once, then the state carried across the chunk summaries.
    Plain PyTorch, differentiable by autograd. Counted as the sequential
    oracle (``kernels.ref.ssd_scan_ref``) at the same shapes: 2 hd ds
    FLOPs a token and head in its one product (y_t = S_t C_t), and the
    backward's one per operand that needs a gradient (C, and the state
    if x, dt, la or Bm do)."""
    B, S, nh, hd = x.shape
    fwd = 2 * B * nh * S * hd * Bm.shape[-1]
    grads = Cm.requires_grad + any(t.requires_grad for t in (x, dt, la, Bm))
    return count_as(_ssd_chunked, (x, dt, la, Bm, Cm, chunk), fwd,
                    fwd * grads)


def mamba2_forward(cfg: ModelConfig, p: dict, x: Tensor,
                   force_ref: bool = False):
    """Full-sequence SSD. x [B,S,d] -> (y [B,S,d], MambaCache)."""
    B, S, _ = x.shape
    d_in, nh, hd, _ = dims(cfg)
    g = cfg.ssm.n_groups
    ds = g * cfg.ssm.d_state
    z, xi_raw, Bc, Cc, dt = _split_proj(cfg, p, x)
    bc_raw = torch.cat([Bc, Cc], dim=-1)
    xi = _conv_full(p["conv_x"], p["conv_b_x"], xi_raw)
    bc = _conv_full(p["conv_bc"], p["conv_b_bc"], bc_raw)
    dt = _step_size(cfg, p, dt)                                    # [B,S,nh]
    la = dt * -torch.exp(p["A_log"].float())                       # log decay
    xh = xi.reshape(B, S, nh, hd)
    args = (xh, dt, la, bc[..., :ds], bc[..., ds:])
    sharded = None
    if force_ref and is_dtensor(xh):  # sharded: per rank's heads
        sharded = on_local_heads(
            lambda *a: ssd_chunked(*a, cfg.ssm.chunk), args,
            (0, 0, 0, 0, 0), (2, 2, 2, None, None), ((0, 2), (0, 1)))
    if sharded is not None:
        y, s_final = sharded
    elif force_ref:
        y, s_final = _per_group(
            lambda *a: ssd_chunked(*a, cfg.ssm.chunk), g, *args)
    else:                           # one kernel launch a group
        y, s_final = _per_group(kops.ssd_scan, g, *args)
    y = acc(y) + p["D"][None, None, :, None] * acc(xh)
    y = _gated_norm(cfg, p, y.reshape(B, S, d_in).to(x.dtype), z)
    out = torch.matmul(y, p["out_proj"])
    K = cfg.ssm.d_conv
    cache = MambaCache(conv_x=_tail(xi_raw, K - 1),
                       conv_bc=_tail(bc_raw, K - 1), ssd=s_final, length=S)
    return out, cache


def init_mamba_cache(cfg: ModelConfig, batch: int, device,
                     lead: tuple = ()) -> MambaCache:
    """Zeroed recurrent state at length 0, leaves stacked on ``lead``."""
    d_in, nh, hd, ds = dims(cfg)
    K = cfg.ssm.d_conv
    return MambaCache(
        conv_x=torch.zeros(lead + (batch, K - 1, d_in), dtype=cfg.tdtype,
                           device=device),
        conv_bc=torch.zeros(lead + (batch, K - 1,
                                    2 * cfg.ssm.n_groups * ds),
                            dtype=cfg.tdtype, device=device),
        ssd=torch.zeros(lead + (batch, nh, hd, ds), dtype=torch.float32,
                        device=device),
        length=0)


def mamba2_decode(cfg: ModelConfig, p: dict, x: Tensor, cache: MambaCache):
    """Single-token recurrence. x [B,1,d] -> (y [B,1,d], next MambaCache).
    The SSD state is updated in place: the returned cache's ``ssd`` is
    ``cache.ssd`` itself."""
    B = x.shape[0]
    d_in, nh, hd, _ = dims(cfg)
    g = cfg.ssm.n_groups
    ds = g * cfg.ssm.d_state
    z, xi, Bc, Cc, dt = _split_proj(cfg, p, x)
    bc = torch.cat([Bc, Cc], dim=-1)
    win_x = torch.cat([cache.conv_x, xi], dim=1)         # [B,K,d_in]
    win_bc = torch.cat([cache.conv_bc, bc], dim=1)       # [B,K,2ds]
    cx = torch.einsum("bkc,kc->bc", win_x, p["conv_x"]) + p["conv_b_x"]
    cbc = torch.einsum("bkc,kc->bc", win_bc, p["conv_bc"]) + p["conv_b_bc"]
    xi = torch.nn.functional.silu(cx.float()).to(x.dtype)
    bc_act = torch.nn.functional.silu(cbc.float()).to(x.dtype)
    Bc, Cc = bc_act[:, :ds], bc_act[:, ds:]
    dt = _step_size(cfg, p, dt[:, 0])
    a = torch.exp(dt * -torch.exp(p["A_log"].float()))  # [B,nh]
    xh = xi.reshape(B, nh, hd).float()
    # heads [j nh / g, (j + 1) nh / g) read group j's B and C; the state
    # is updated in place (two passes over it), then read once
    Bh, Ch = (t.float().reshape(B, g, 1, -1).expand(-1, -1, nh // g, -1)
              .reshape(B, nh, -1) for t in (Bc, Cc))
    s_new = cache.ssd.mul_(a[:, :, None, None]).addcmul_(
        (dt[:, :, None] * xh)[..., None], Bh[:, :, None, :])
    y = torch.matmul(s_new, Ch[..., None])[..., 0]
    y = y + p["D"][None, :, None] * xh
    y = _gated_norm(cfg, p, y.reshape(B, 1, d_in).to(x.dtype), z)
    out = torch.matmul(y, p["out_proj"])
    return out, MambaCache(conv_x=win_x[:, 1:], conv_bc=win_bc[:, 1:],
                           ssd=s_new, length=cache.length + 1)
