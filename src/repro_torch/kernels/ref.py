"""Plain PyTorch ports of the JAX package's kernel oracles
(``repro/kernels/ref.py``): the correctness contract the kernels and their
plain versions are held to.

Unlike the kernels, the oracles mask with -inf and take a full softmax, so
a fully masked row differs between the two; the tests keep such rows out.
Shapes use BH = batch * heads flattened into the leading dim.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor,
                        causal: bool = True,
                        window: int | None = None) -> Tensor:
    """q,k,v [BH, S, hd] (kv already broadcast to query heads)."""
    S, hd = q.shape[1], q.shape[-1]
    s = torch.einsum("bqh,bkh->bqk", q, k).float() / (hd ** 0.5)
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
                         valid: Tensor) -> Tensor:
    """q [BH, G, hd]; k,v [BH, C, hd]; valid [BH, C] bool -> [BH, G, hd]."""
    hd = q.shape[-1]
    s = torch.einsum("bgh,bch->bgc", q, k).float() / (hd ** 0.5)
    s = torch.where(valid[:, None, :], s, torch.full_like(s, -torch.inf))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bgc,bch->bgh", w, v)


def fused_ffn_ref(x: Tensor, wg: Tensor, wu: Tensor, wd: Tensor) -> Tensor:
    """Batched SwiGLU FFN oracle. x [E,T,d]; wg,wu [E,d,f]; wd [E,f,d]."""
    g = torch.einsum("etd,edf->etf", x, wg)
    u = torch.einsum("etd,edf->etf", x, wu)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return torch.einsum("etf,efd->etd", h, wd)
