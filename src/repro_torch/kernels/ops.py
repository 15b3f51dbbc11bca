"""Model-facing wrappers around the kernels: layout adapters and dispatch.

Counterpart of ``repro/kernels/ops.py``. The adapters translate the model
layouts (``[B, S, nh, hd]``, the stacked cache's ``[B, C, nkv, hd]``, the
scans' per-head ``[B, S, nh]`` and shared ``[B, S, ds]`` rows) into the
kernels' layouts as strided views, so no operand is copied.

Dispatch: the kernel modules take the plain version for a CPU tensor and
launch the Hopper kernel for a CUDA tensor, or raise. ``force_ref=True``
bypasses both and runs the JAX package's oracle (``ref``); only tests and
``chip_smoke.py`` pass it.
"""
from __future__ import annotations

import torch

from . import ref
from .decode_attention import decode_attention as _decode
from .decode_attention import paged_decode_attention as _paged
from .decode_attention import paged_gather
from .flash_attention import flash_attention as _flash
from .fused_ffn import fused_ffn as _ffn
from .rwkv6_scan import rwkv6_scan as _rwkv
from .ssd_scan import ssd_scan as _ssd

Tensor = torch.Tensor


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int | None = None,
                    force_ref: bool = False) -> Tensor:
    """Model layout: q [B,S,nh,hd]; k,v [B,S,nkv,hd] -> [B,S,nh,hd]."""
    B, S, nh, hd = q.shape
    nkv = k.shape[2]
    G = nh // nkv
    if force_ref:
        qf = q.reshape(B, S, nkv, G, hd).permute(0, 2, 3, 1, 4) \
            .reshape(B * nkv * G, S, hd)
        kf = k.permute(0, 2, 1, 3)[:, :, None].expand(B, nkv, G, S, hd) \
            .reshape(B * nkv * G, S, hd)
        vf = v.permute(0, 2, 1, 3)[:, :, None].expand(B, nkv, G, S, hd) \
            .reshape(B * nkv * G, S, hd)
        out = ref.flash_attention_ref(qf, kf, vf, causal=causal,
                                      window=window)
        return out.reshape(B, nkv, G, S, hd).permute(0, 3, 1, 2, 4) \
            .reshape(B, S, nh, hd)
    qk = q.reshape(B, S, nkv, G, hd).permute(0, 2, 3, 1, 4)
    out = _flash(qk, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                 causal=causal, window=window)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, nh, hd)


def decode_attention(q: Tensor, k: Tensor, v: Tensor, valid: Tensor, *,
                     force_ref: bool = False) -> Tensor:
    """q [B,1,nh,hd]; k,v [B,C,nkv,hd]; valid [B,C] -> [B,1,nh,hd]."""
    B, _, nh, hd = q.shape
    C, nkv = k.shape[1], k.shape[2]
    G = nh // nkv
    if force_ref:
        kk = k.permute(0, 2, 1, 3).reshape(B * nkv, C, hd)
        vv = v.permute(0, 2, 1, 3).reshape(B * nkv, C, hd)
        vd = valid[:, None, :].expand(B, nkv, C).reshape(B * nkv, C)
        out = ref.decode_attention_ref(q.reshape(B * nkv, G, hd), kk, vv, vd)
        return out.reshape(B, 1, nh, hd)
    out = _decode(q.reshape(B, nkv, G, hd), k.permute(0, 2, 1, 3),
                  v.permute(0, 2, 1, 3), valid.contiguous())
    return out.reshape(B, 1, nh, hd)


def paged_decode_attention(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                           block_tables: Tensor, pos: Tensor, *,
                           force_ref: bool = False) -> Tensor:
    """Model layout: q [B,1,nh,hd]; k/v_pool [P,bs,nkv,hd];
    block_tables [B,n_bt] int32; pos [B] int32 -> [B,1,nh,hd].

    ``force_ref`` densifies the pool through the block table (sentinels
    clipped to block P - 1, masked by position and by sentinel) and runs
    the reference attend, as the JAX package's cross-check path does.
    """
    B, _, nh, hd = q.shape
    nkv = k_pool.shape[2]
    G = nh // nkv
    if force_ref:
        kk, vv, valid = paged_gather(k_pool, v_pool, block_tables, pos)
        C = kk.shape[1]
        out = ref.decode_attention_ref(
            q.reshape(B * nkv, G, hd),
            kk.permute(0, 2, 1, 3).reshape(B * nkv, C, hd),
            vv.permute(0, 2, 1, 3).reshape(B * nkv, C, hd),
            valid[:, None, :].expand(B, nkv, C).reshape(B * nkv, C))
        return out.reshape(B, 1, nh, hd)
    out = _paged(q.reshape(B, nkv, G, hd), k_pool, v_pool, block_tables, pos)
    return out.reshape(B, 1, nh, hd)


def fused_ffn(x, wg, wu, wd, *, force_ref: bool = False) -> Tensor:
    """x [E,T,d]; wg,wu [E,d,f]; wd [E,f,d] -> [E,T,d]."""
    if force_ref:
        return ref.fused_ffn_ref(x, wg, wu, wd)
    return _ffn(x, wg, wu, wd)


def rwkv6_scan(r: Tensor, k: Tensor, v: Tensor, la: Tensor, u: Tensor, *,
               force_ref: bool = False):
    """Model layout: r,k,v [B,S,nh,hd]; la [B,S,nh,hd] f32; u [nh,hd] f32
    -> (y [B,S,nh,hd] in r's dtype, s_final [B,nh,hd,hd] f32).

    The kernel gets ``[B, nh, S, hd]`` views and ``u`` with a head stride
    and a batch stride of 0. ``force_ref`` runs the sequential oracle.
    """
    B, S, nh, hd = r.shape
    if force_ref:
        def flat(t):
            return t.permute(0, 2, 1, 3).reshape(B * nh, S, hd)
        y, sf = ref.rwkv_scan_ref(flat(r), flat(k), flat(v), flat(la),
                                  u[None].expand(B, nh, hd)
                                  .reshape(B * nh, hd))
        return (y.reshape(B, nh, S, hd).permute(0, 2, 1, 3),
                sf.reshape(B, nh, hd, hd))
    y, sf = _rwkv(r.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                  v.permute(0, 2, 1, 3), la.permute(0, 2, 1, 3),
                  u[None].expand(B, nh, hd))
    return y.permute(0, 2, 1, 3), sf


def ssd_scan(x: Tensor, dt: Tensor, la: Tensor, Bm: Tensor, Cm: Tensor, *,
             force_ref: bool = False):
    """Model layout: x [B,S,nh,hd]; dt, la [B,S,nh] f32; Bm, Cm [B,S,ds]
    shared by the heads of a row -> (y [B,S,nh,hd] in x's dtype,
    s_final [B,nh,hd,ds] f32).

    The kernel gets ``[B, nh, S, ...]`` views, with ``Bm``/``Cm`` on a head
    stride of 0. ``force_ref`` runs the sequential oracle (which takes
    ``Bm``/``Cm`` repeated per head).
    """
    B, S, nh, hd = x.shape
    ds = Bm.shape[-1]
    if force_ref:
        def rows(t):
            return t[:, None].expand(B, nh, S, ds).reshape(B * nh, S, ds)
        y, sf = ref.ssd_scan_ref(
            x.permute(0, 2, 1, 3).reshape(B * nh, S, hd),
            dt.permute(0, 2, 1).reshape(B * nh, S),
            la.permute(0, 2, 1).reshape(B * nh, S), rows(Bm), rows(Cm))
        return (y.reshape(B, nh, S, hd).permute(0, 2, 1, 3),
                sf.reshape(B, nh, hd, ds))
    y, sf = _ssd(x.permute(0, 2, 1, 3), dt.permute(0, 2, 1),
                 la.permute(0, 2, 1), Bm[:, None].expand(B, nh, S, ds),
                 Cm[:, None].expand(B, nh, S, ds))
    return y.permute(0, 2, 1, 3), sf
