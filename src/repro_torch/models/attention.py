"""GQA attention: RoPE, qk-norm, prefill and slot-cache decode.

The dense slot path of ``repro.models.attention``:

  * ``attn_forward``        — full-sequence causal attention (prefill);
    returns the K/V tensors so prefill can seed a decode cache.
  * ``attn_decode_stacked`` — one-token step that writes the new token's
    K/V in place into the layer-stacked cache and attends over it.

Attention goes through ``kernels.ops`` (the Hopper kernels on a CUDA
device, their plain versions on the CPU) at every shape; the JAX package's
``% 16`` gate existed only because Pallas blocks must divide the array.
``force_ref=True`` takes the JAX package's reference ``_sdpa`` instead.
The int8 ``QuantKVCache``, ``PagedKVCache`` and sliding-window ring
buffers are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import ops as kops
from .config import ModelConfig
from .layers import _he, apply_rope, rope_freqs

Tensor = torch.Tensor


class KVCache(NamedTuple):
    """Layer-stacked dense decode cache.

    ``k``/``v`` are ``[L, B, C, nkv, hd]`` (C = capacity) and are updated in
    place by :func:`attn_decode_stacked`. ``length`` is the aligned batch's
    position as a host int (every row and layer sits at the same position),
    so writing the next token's slot needs no device-to-host read.
    """

    k: Tensor
    v: Tensor
    length: int

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


def init_attn(cfg: ModelConfig, gen: torch.Generator, lead: tuple) -> dict:
    hd, nh, nkv, d = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    p = {
        "wq": _he(gen, lead + (d, nh * hd), cfg.tdtype, fan_in=d),
        "wk": _he(gen, lead + (d, nkv * hd), cfg.tdtype, fan_in=d),
        "wv": _he(gen, lead + (d, nkv * hd), cfg.tdtype, fan_in=d),
        "wo": _he(gen, lead + (nh * hd, d), cfg.tdtype, fan_in=nh * hd),
    }
    if cfg.qk_norm:   # Qwen3-style per-head RMS norm on q and k
        p["q_norm"] = torch.ones(lead + (hd,), dtype=cfg.tdtype,
                                 device=gen.device)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=cfg.tdtype,
                                 device=gen.device)
    return p


def _qk_rms(x: Tensor, scale: Tensor) -> Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return (y * scale.float()).to(x.dtype)


def _project_qkv(cfg: ModelConfig, p: dict, x: Tensor, positions: Tensor):
    B, S, _ = x.shape
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = torch.matmul(x, p["wq"]).reshape(B, S, nh, hd)
    k = torch.matmul(x, p["wk"]).reshape(B, S, nkv, hd)
    v = torch.matmul(x, p["wv"]).reshape(B, S, nkv, hd)
    if cfg.qk_norm:
        q = _qk_rms(q, p["q_norm"])
        k = _qk_rms(k, p["k_norm"])
    cos, sin = rope_freqs(cfg, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _sdpa(cfg: ModelConfig, q: Tensor, k: Tensor, v: Tensor,
          mask: Tensor) -> Tensor:
    """Reference attention. q [B,S,nh,hd], k/v [B,T,nkv,hd],
    mask [B or 1, S, T] bool."""
    B, S, nh, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(B, S, nkv, nh // nkv, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).float() / (hd ** 0.5)
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkh->bskgh", w, v).reshape(B, S, nh, hd)


def causal_mask(q_pos: Tensor, kv_pos: Tensor) -> Tensor:
    """[1, S, T] bool: kv visible to query."""
    return (kv_pos[None, :] <= q_pos[:, None])[None]


def attn_forward(cfg: ModelConfig, p: dict, x: Tensor,
                 positions: Optional[Tensor] = None,
                 force_ref: bool = False):
    """Full-sequence causal attention. x [B,S,d] -> (y [B,S,d], (k, v))."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)
    if force_ref:
        out = _sdpa(cfg, q, k, v, causal_mask(positions, positions))
    else:
        out = kops.flash_attention(q, k, v, causal=True)
    y = torch.matmul(out.reshape(B, S, -1), p["wo"])
    return y, (k, v)


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device, dtype=None) -> KVCache:
    """Zeroed layer-stacked dense cache at position 0."""
    shape = (cfg.n_layers, batch, capacity, cfg.n_kv_heads, cfg.hd)
    dtype = dtype or cfg.tdtype
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0)


def cache_from_prefill(cfg: ModelConfig, k: Tensor, v: Tensor,
                       capacity: int) -> KVCache:
    """Seed a decode cache with prefill K/V, stacked ``[L, B, S, nkv, hd]``:
    slots ``[0, S)`` hold the prompt, the rest are zero."""
    L, B, S = k.shape[:3]
    if S > capacity:
        raise ValueError(f"prompt length {S} exceeds cache capacity "
                         f"{capacity}")
    cache = init_cache(cfg, B, capacity, k.device, k.dtype)
    cache.k[:, :, :S] = k
    cache.v[:, :, :S] = v
    return cache._replace(length=S)


def _decode_valid(pos: int, C: int, device) -> Tensor:
    """[1, C] bool mask over cache slots: slots <= pos are filled."""
    return (torch.arange(C, device=device) <= pos)[None]


def _decode_attend(cfg: ModelConfig, p: dict, q: Tensor, k: Tensor,
                   v: Tensor, valid: Tensor, force_ref: bool) -> Tensor:
    """Attend one query token over the cache and project out.
    q [B,1,nh,hd]; k/v [B,C,nkv,hd]; valid [B or 1, C]."""
    B, C = q.shape[0], k.shape[1]
    valid = valid.expand(B, C)
    if force_ref:
        out = _sdpa(cfg, q, k, v, valid[:, None, :])
    else:
        out = kops.decode_attention(q, k, v, valid)
    return torch.matmul(out.reshape(B, 1, -1), p["wo"])


def attn_decode_stacked(cfg: ModelConfig, p: dict, x: Tensor, kv: KVCache,
                        pos: int, layer: int,
                        force_ref: bool = False) -> Tensor:
    """One-token step writing straight into the STACKED cache.

    x [B,1,d]; ``pos`` is the aligned batch's position (a host int), the
    slot the new token's K/V land in. The JAX package's
    ``dynamic_update_slice`` at a traced position becomes an in-place write
    into ``kv.k[layer, :, slot]`` / ``kv.v[layer, :, slot]``; like that op,
    a position past the capacity writes the last slot. No device-to-host
    read happens here. Returns y [B,1,d]; the caller owns the position.
    """
    q, k_new, v_new = _project_qkv(
        cfg, p, x, torch.arange(pos, pos + 1, device=x.device))
    C = kv.capacity
    slot = min(pos, C - 1)
    kv.k[layer, :, slot] = k_new[:, 0]
    kv.v[layer, :, slot] = v_new[:, 0]
    valid = _decode_valid(pos, C, x.device)
    return _decode_attend(cfg, p, q, kv.k[layer], kv.v[layer], valid,
                          force_ref)
