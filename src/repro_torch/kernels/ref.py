"""Plain PyTorch ports of the JAX package's kernel oracles
(``repro/kernels/ref.py``): the correctness contract the kernels and their
plain versions are held to.

Unlike the kernels, the oracles mask with -inf and take a full softmax, so
a fully masked row differs between the two; the tests keep such rows out.
Shapes use BH = batch * heads flattened into the leading dim.
"""
from __future__ import annotations

import torch

from ..compat import acc

Tensor = torch.Tensor


def _scaled(s: Tensor, hd: int, scale) -> Tensor:
    """Scores times the softmax scale (None: divided by ``hd ** 0.5``)."""
    return s / (hd ** 0.5) if scale is None else s * scale


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor,
                        causal: bool = True,
                        window: int | None = None,
                        scale: float | None = None) -> Tensor:
    """q,k,v [BH, S, hd] (kv already broadcast to query heads)."""
    S, hd = q.shape[1], q.shape[-1]
    s = _scaled(torch.einsum("bqh,bkh->bqk", q, k).float(), hd, scale)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    s = torch.where(mask[None], s, torch.full_like(s, -torch.inf))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bqk,bkh->bqh", w, v)


def decode_attention_ref(q: Tensor, k: Tensor, v: Tensor,
                         valid: Tensor, scale: float | None = None) -> Tensor:
    """q [BH, G, hd]; k,v [BH, C, hd]; valid [BH, C] bool -> [BH, G, hd]."""
    hd = q.shape[-1]
    s = _scaled(torch.einsum("bgh,bch->bgc", q, k).float(), hd, scale)
    s = torch.where(valid[:, None, :], s, torch.full_like(s, -torch.inf))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bgc,bch->bgh", w, v)


def fused_ffn_ref(x: Tensor, wg: Tensor, wu: Tensor, wd: Tensor) -> Tensor:
    """Batched SwiGLU FFN oracle. x [E,T,d]; wg,wu [E,d,f]; wd [E,f,d]."""
    g = torch.einsum("etd,edf->etf", x, wg)
    u = torch.einsum("etd,edf->etf", x, wu)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return torch.einsum("etf,efd->etd", h, wd)


def grouped_ffn_ref(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor,
                    group_sizes: Tensor) -> Tensor:
    """Grouped (per-expert) SwiGLU FFN oracle for the MoE's dropless
    dispatch. x [T, d] sorted by expert; w_* [E, ...]; group_sizes [E]
    sums to T."""
    T = x.shape[0]
    bounds = torch.cumsum(group_sizes, 0)
    eid = torch.searchsorted(bounds, torch.arange(T, device=x.device,
                                                  dtype=bounds.dtype),
                             right=True)
    g = torch.einsum("td,tdf->tf", x, w_gate[eid])
    u = torch.einsum("td,tdf->tf", x, w_up[eid])
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return torch.einsum("tf,tfd->td", h, w_down[eid])


def ssd_scan_ref(x: Tensor, dt: Tensor, a: Tensor, Bm: Tensor, Cm: Tensor,
                 s0: Tensor | None = None):
    """Sequential Mamba2 SSD oracle.

    x [BH,S,hd], dt [BH,S], a [BH,S] log-decay (= A*dt, < 0),
    Bm/Cm [BH,S,ds]. Returns (y [BH,S,hd], s_final [BH,hd,ds] f32; f64
    for f64 inputs).
    """
    BH, S, hd = x.shape
    ds = Bm.shape[-1]
    xf, bf, cf, dtf, af = (acc(t) for t in (x, Bm, Cm, dt, a))
    s = (torch.zeros(BH, hd, ds, dtype=xf.dtype, device=x.device)
         if s0 is None else s0.to(xf.dtype))
    ys = []
    for t in range(S):
        s = torch.exp(af[:, t])[:, None, None] * s \
            + dtf[:, t, None, None] * torch.einsum("bh,bs->bhs", xf[:, t],
                                                   bf[:, t])
        ys.append(torch.einsum("bs,bhs->bh", cf[:, t], s))
    return torch.stack(ys, dim=1).to(x.dtype), s


def rwkv_scan_ref(r: Tensor, k: Tensor, v: Tensor, la: Tensor, u: Tensor,
                  s0: Tensor | None = None):
    """Sequential RWKV6 wkv oracle.

    r,k,v,la [BH,S,hd] (la log decay < 0), u [BH,hd].
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T); S_t = diag(w_t) S_{t-1} + k_t v_t^T.
    Returns (y [BH,S,hd], s_final [BH,hd,hd] f32; f64 for f64 inputs).
    """
    BH, S, hd = r.shape
    rf, kf, vf, laf = (acc(t) for t in (r, k, v, la))
    uf = acc(u)
    s = (torch.zeros(BH, hd, hd, dtype=rf.dtype, device=r.device)
         if s0 is None else s0.to(rf.dtype))
    ys = []
    for t in range(S):
        kv = torch.einsum("bt,bu->btu", kf[:, t], vf[:, t])
        ys.append(torch.einsum("bt,btu->bu", rf[:, t], s + uf[:, :, None] * kv))
        s = torch.exp(laf[:, t])[:, :, None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s
