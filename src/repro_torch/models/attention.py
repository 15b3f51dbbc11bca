"""GQA attention: RoPE, qk-norm, prefill, slot-cache and paged decode.

The full-precision paths of ``repro.models.attention``:

  * ``attn_forward``        — full-sequence causal attention (prefill);
    returns the K/V tensors so prefill can seed a decode cache.
  * ``attn_decode_stacked`` — one-token step that writes the new token's
    K/V in place into the layer-stacked slot cache and attends over it, at
    one position for the whole batch (a 0-d tensor) or at one position per
    row (a ``[B]`` tensor, continuous batching).
  * ``attn_decode_paged``   — one-token step against the paged block pool.

Attention goes through ``kernels.ops`` (the Hopper kernels on a CUDA
device, their plain versions on the CPU) at every shape; the JAX package's
``% 16`` gate existed only because Pallas blocks must divide the array.
``force_ref=True`` takes the JAX package's reference path instead. The
int8 ``QuantKVCache`` (and int8 paged pools) and sliding-window ring
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
    place by :func:`attn_decode_stacked`. ``length`` is the position of the
    next token, the same in every layer, an int32 tensor on the cache's
    device that the decode step advances in place: 0-d when every row sits
    at the same position (``DecodeEngine``), or ``[B]`` with one position
    per row (``ContinuousBatchingEngine``). Neither is read on the host, so
    a captured CUDA graph of the step reads and advances the live value.
    """

    k: Tensor
    v: Tensor
    length: Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


class PagedKVCache(NamedTuple):
    """Block-pooled KV cache (full precision), as ``repro``'s.

        k, v          [L, P + 1, bs, nkv, hd]  pool of P blocks, plus one
                                               trash block at index P
        block_tables  [B, n_bt] int32          per-slot logical -> physical
                                               map; entry P = unassigned
        length        [B] int32                per-slot position of the next
                                               token, the same in every layer

    Logical position ``p`` of slot ``b`` lives at
    ``pool[layer, block_tables[b, p // bs], p % bs]``. The JAX package
    drops writes through a sentinel entry (``mode="drop"``); PyTorch's
    indexed writes have no drop mode, so here the sentinel addresses the
    trash block at index P, which absorbs those writes (retired rows riding
    a chunk, prefill pads) without a host check, and which no read sees:
    attention reads ``k[layer, :P]`` and masks sentinel entries. The JAX
    package's pool is ``k[:, :P]``.
    """

    k: Tensor
    v: Tensor
    block_tables: Tensor
    length: Tensor

    @property
    def n_blocks(self) -> int:
        return self.k.shape[1] - 1

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def capacity(self) -> int:
        """Per-slot logical capacity (block-table width x block size)."""
        return self.block_tables.shape[1] * self.k.shape[2]


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
               device, dtype=None, n_layers: Optional[int] = None) -> KVCache:
    """Zeroed layer-stacked dense cache at position 0, with ``n_layers``
    layers (default ``cfg.n_layers``; the hybrid's shared block has one per
    application)."""
    L = cfg.n_layers if n_layers is None else n_layers
    shape = (L, batch, capacity, cfg.n_kv_heads, cfg.hd)
    dtype = dtype or cfg.tdtype
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((), dtype=torch.int32, device=device))


def cache_from_prefill(cfg: ModelConfig, k: Tensor, v: Tensor,
                       capacity: int) -> KVCache:
    """Seed a decode cache with prefill K/V, stacked ``[L, B, S, nkv, hd]``:
    slots ``[0, S)`` hold the prompt, the rest are zero."""
    L, B, S = k.shape[:3]
    if S > capacity:
        raise ValueError(f"prompt length {S} exceeds cache capacity "
                         f"{capacity}")
    cache = init_cache(cfg, B, capacity, k.device, k.dtype, n_layers=L)
    cache.k[:, :, :S] = k
    cache.v[:, :, :S] = v
    cache.length.fill_(S)
    return cache


def init_paged_cache(cfg: ModelConfig, batch: int, n_blocks: int,
                     block_size: int, n_bt: int, device,
                     dtype=None) -> PagedKVCache:
    """Zeroed paged pool (plus its trash block), all-sentinel block tables
    and zero positions. ``n_bt`` is the block-table width, the per-slot
    logical capacity in blocks."""
    shape = (cfg.n_layers, n_blocks + 1, block_size, cfg.n_kv_heads, cfg.hd)
    dtype = dtype or cfg.tdtype
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        block_tables=torch.full((batch, n_bt), n_blocks, dtype=torch.int32,
                                device=device),
        length=torch.zeros(batch, dtype=torch.int32, device=device))


def _decode_valid(pos: Tensor, C: int, device) -> Tensor:
    """[1 or B, C] bool mask over cache slots: slots <= pos are filled
    (``pos`` a 0-d shared position, or a ``[B]`` tensor of per-row
    positions)."""
    slots = torch.arange(C, device=device)
    if pos.dim() == 0:
        return (slots <= pos)[None]
    return slots[None] <= pos[:, None]


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


def _rope_positions(pos: Tensor) -> Tensor:
    """RoPE positions of the new token: [1] for a shared position, [B, 1]
    per row."""
    return pos.reshape(1) if pos.dim() == 0 else pos[:, None]


def attn_decode_stacked(cfg: ModelConfig, p: dict, x: Tensor, kv: KVCache,
                        pos: Tensor, layer: int,
                        force_ref: bool = False) -> Tensor:
    """One-token step writing straight into the STACKED cache.

    x [B,1,d]; ``pos`` is the new token's position, an int32 tensor: 0-d
    and shared by every row, or ``[B]``, one per row. The JAX package's
    ``dynamic_update_slice`` at a traced position becomes an in-place write
    into ``kv.k[layer, :, slot]``; like that op, a shared position past the
    capacity writes the last slot. Its per-row scatter drops a row whose
    position is past the capacity (a retired row riding a chunk); here that
    row's slot index is clamped and its old value written back. No
    device-to-host read happens here (the slot is an index tensor, never a
    host int), so the step can be captured in a CUDA graph. Returns
    y [B,1,d]; the caller owns the position.
    """
    q, k_new, v_new = _project_qkv(cfg, p, x, _rope_positions(pos))
    C = kv.capacity
    slot = pos.clamp(max=C - 1)
    if pos.dim() == 0:
        idx = slot.reshape(1).long()
        kv.k[layer].index_copy_(1, idx, k_new)
        kv.v[layer].index_copy_(1, idx, v_new)
    else:
        rows = torch.arange(x.shape[0], device=x.device)
        keep = (pos >= C)[:, None, None]
        kv.k[layer, rows, slot] = torch.where(keep, kv.k[layer, rows, slot],
                                              k_new[:, 0])
        kv.v[layer, rows, slot] = torch.where(keep, kv.v[layer, rows, slot],
                                              v_new[:, 0])
    valid = _decode_valid(pos, C, x.device)
    return _decode_attend(cfg, p, q, kv.k[layer], kv.v[layer], valid,
                          force_ref)


def attn_decode_paged(cfg: ModelConfig, p: dict, x: Tensor,
                      pc: PagedKVCache, pos: Tensor, layer: int,
                      force_ref: bool = False) -> Tensor:
    """One-token step against the paged block pool.

    x [B,1,d]; ``pos`` [B] int32 the per-slot positions. The new token's
    K/V is written in place at ``pool[layer, block_tables[b, pos // bs],
    pos % bs]``; a position past the block table, or behind a sentinel
    entry, writes the trash block (the JAX package drops those writes).
    The attend runs ``paged_decode_attention`` over the pool directly (the
    Hopper kernel on a CUDA device, its plain version on the CPU).
    ``force_ref=True`` takes the JAX package's reference path instead:
    gather the slot's blocks into the dense ``[B, C, nkv, hd]`` layout
    (sentinels clipped to a real block, hidden by the ``slots <= pos``
    mask) and reuse the slot attend. Returns y [B,1,d].
    """
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(cfg, p, x, pos[:, None])
    P, bs = pc.n_blocks, pc.block_size
    n_bt = pc.block_tables.shape[1]
    rows = torch.arange(B, device=x.device)
    bidx = pos // bs
    blk = torch.where(bidx < n_bt,
                      pc.block_tables[rows, bidx.clamp(max=n_bt - 1)], P)
    off = pos % bs
    pc.k[layer, blk, off] = k_new[:, 0]
    pc.v[layer, blk, off] = v_new[:, 0]
    if not force_ref:
        out = kops.paged_decode_attention(q, pc.k[layer, :P], pc.v[layer, :P],
                                          pc.block_tables, pos)
        return torch.matmul(out.reshape(B, 1, -1), p["wo"])
    # the JAX package's gather path masks by position only: a sentinel
    # entry reads a clipped real block, hidden because it lies past pos
    k, v, _ = kops.paged_gather(pc.k[layer, :P], pc.v[layer, :P],
                                pc.block_tables, pos)
    return _decode_attend(cfg, p, q, k, v,
                          _decode_valid(pos, k.shape[1], x.device),
                          force_ref=True)
