"""GQA attention: RoPE, qk-norm, prefill, slot-cache and paged decode.

The paths of ``repro.models.attention`` for full attention:

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
``force_ref=True`` takes the JAX package's reference path instead.

The int8 cache (``ModelConfig.kv_cache_dtype="int8"``): the slot cache is
a :class:`QuantKVCache` and the paged pool carries ``k_scale``/``v_scale``
pools beside its int8 codes, both quantised symmetrically by absmax per
(position, head) (:func:`_quantize`). A decode step writes codes and
scales in place, dequantises the layer (:func:`_dequantize`) and attends
over it with the slot decode kernel; an int8 paged pool is gathered
through its block table first, so it never runs the paged kernel. No
kernel reads int8, as in the JAX package.

The softmax scale is ``hd ** -0.5`` unless the config gives its own
(``attn_scale``: the published Zamba2's ``(hd / 2) ** -0.5``), which every
path and kernel takes.

Sliding window (``ModelConfig.sliding_window``): prefill masks keys more
than ``window - 1`` positions back (the flash kernel's ``window``), and the
slot cache, full precision or int8, is a ring of ``min(capacity,
window)`` slots: position ``p`` lives at slot ``p % C``
(:func:`seed_slots`, :func:`_decode_valid`). The paged pool refuses a
window, as the JAX package's does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..compat import is_dtensor
from ..kernels import ops as kops
from ..roofline.analysis import note_attention_output, note_attention_scores
from .config import ModelConfig
from .layers import (_he, apply_rope, merge_dims, on_local_heads,
                     rope_freqs, split_dim)

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


class QuantKVCache(NamedTuple):
    """Layer-stacked int8 decode cache: symmetric absmax quantisation per
    (position, head), as ``repro``'s.

        k, v              int8 [L, B, C, nkv, hd]  codes in [-127, 127]
        k_scale, v_scale  f32  [L, B, C, nkv]      absmax / 127 (>= 1e-8)
        length            int32, as :class:`KVCache`'s

    Updated in place by :func:`attn_decode_stacked`, like ``KVCache``.
    """

    k: Tensor
    v: Tensor
    k_scale: Tensor
    v_scale: Tensor
    length: Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


class PagedKVCache(NamedTuple):
    """Block-pooled KV cache, as ``repro``'s.

        k, v          [L, P + 1, bs, nkv, hd]  pool of P blocks, plus one
                                               trash block at index P
        block_tables  [B, n_bt] int32          per-slot logical -> physical
                                               map; entry P = unassigned
        length        [B] int32                per-slot position of the next
                                               token, the same in every layer
        k_scale,      [L, P + 1, bs, nkv] f32  absmax scales when the pool is
        v_scale                                int8 (``kv_cache_dtype=
                                               "int8"``), trash block
                                               included; None otherwise

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
    k_scale: Optional[Tensor] = None
    v_scale: Optional[Tensor] = None

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


def _quantize(t: Tensor):
    """t [..., hd] -> (int8 codes [..., hd], f32 scale [...]): absmax over
    ``hd`` in f32, ``scale = max(amax / 127, 1e-8)``, codes rounded half
    to even (``torch.round``, as ``jnp.round``) and clipped to +-127."""
    tf = t.float()
    scale = torch.clamp(tf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize(q: Tensor, scale: Tensor, dtype) -> Tensor:
    """Codes times their scales in f32, cast to the activation dtype."""
    return (q.float() * scale[..., None].float()).to(dtype)


def kv_fields(k: Tensor, v: Tensor, int8: bool) -> tuple:
    """What a K/V write stores, as (cache field, values) pairs: ``k`` and
    ``v`` themselves, or for an int8 cache their codes and their scales."""
    if not int8:
        return (("k", k), ("v", v))
    (kq, ks), (vq, vs) = _quantize(k), _quantize(v)
    return (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))


def init_attn(cfg: ModelConfig, gen: torch.Generator, lead: tuple) -> dict:
    hd, nh, nkv, d = cfg.hd, cfg.n_heads, cfg.n_kv_eff, cfg.d_model
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
    hd, nh, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_eff
    q = split_dim(torch.matmul(x, p["wq"]), -1, (nh, hd))
    k = split_dim(torch.matmul(x, p["wk"]), -1, (nkv, hd))
    v = split_dim(torch.matmul(x, p["wv"]), -1, (nkv, hd))
    if cfg.qk_norm:
        q = _qk_rms(q, p["q_norm"])
        k = _qk_rms(k, p["k_norm"])
    cos, sin = rope_freqs(cfg, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _sdpa(cfg: ModelConfig, q: Tensor, k: Tensor, v: Tensor,
          mask: Tensor, pairs: Optional[int] = None) -> Tensor:
    """Reference attention. q [B,S,nh,hd], k/v [B,T,nkv,hd],
    mask [B or 1, S, T] bool; ``pairs``, where the caller knows it, the
    (query, key) pairs the mask keeps per batch row (for the roofline's
    count). On DTensors (a mesh installed) each rank attends its own
    rows and KV heads with their query groups
    (``on_local_heads``), or, where the model axis splits the head
    dimension instead, the einsums run on DTensors (partial scores summed
    over ``model``, as GSPMD lays them out)."""
    if is_dtensor(q):
        mb = 0 if mask.shape[0] == q.shape[0] else None
        out = on_local_heads(lambda *a: _sdpa(cfg, *a, pairs=pairs),
                             (q, k, v, mask), (0, 0, 0, mb), (2, 2, 2, None),
                             ((0, 2),))
        if out is not None:
            return out
    B, S, nh, hd = q.shape
    nkv = k.shape[2]
    qg = split_dim(q, 2, (nkv, nh // nkv))
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    logits = (logits / (hd ** 0.5) if cfg.attn_scale is None
              else logits * cfg.attn_scale)
    masked = note_attention_scores(q, k, mask, pairs)
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = merge_dims(torch.einsum("bkgst,btkh->bskgh", w, v), 2, 3)
    note_attention_output(masked, q, k, v, out)
    return out


def causal_pairs(S: int, window: Optional[int]) -> int:
    """(query, key) pairs a causal mask over S contiguous positions
    keeps: row s sees min(s + 1, window) keys."""
    w = S if window is None else min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def causal_mask(cfg: ModelConfig, q_pos: Tensor, kv_pos: Tensor) -> Tensor:
    """[1, S, T] bool: kv visible to query (causal, and inside the sliding
    window where the config has one)."""
    m = kv_pos[None, :] <= q_pos[:, None]
    if cfg.sliding_window is not None:
        m &= kv_pos[None, :] > q_pos[:, None] - cfg.sliding_window
    return m[None]


def attn_forward(cfg: ModelConfig, p: dict, x: Tensor,
                 positions: Optional[Tensor] = None,
                 force_ref: bool = False):
    """Full-sequence causal attention. x [B,S,d] -> (y [B,S,d], (k, v))."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)
    if force_ref:
        out = _sdpa(cfg, q, k, v, causal_mask(cfg, positions, positions),
                    causal_pairs(S, cfg.sliding_window))
    else:
        out = kops.flash_attention(q, k, v, causal=True,
                                   window=cfg.sliding_window,
                                   scale=cfg.attn_scale)
    y = torch.matmul(merge_dims(out, 2, 3), p["wo"])
    return y, (k, v)


def seed_slots(cfg: ModelConfig, S: int, C: int) -> tuple:
    """Where a prefill of ``S`` positions lands in a decode cache of ``C``
    slots: (positions kept, their slots), int64 index tensors on the CPU.
    Full attention keeps all ``S`` at slots ``[0, S)`` and raises past the
    capacity; a ring keeps the last ``C`` at slots ``p % C``, as the JAX
    package's ``cache_from_prefill`` does."""
    if S <= C:
        kept = torch.arange(S)
        return kept, kept
    if cfg.sliding_window is None:
        raise ValueError(f"prompt length {S} exceeds cache capacity {C}")
    kept = torch.arange(S - C, S)
    return kept, kept % C


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device, dtype=None, n_layers: Optional[int] = None):
    """Zeroed layer-stacked dense cache at position 0, with ``n_layers``
    layers (default ``cfg.n_layers``; the hybrid's shared block has one per
    application) and ``capacity`` slots, a sliding window's ring capped at
    the window: a :class:`QuantKVCache` when the config's KV cache is int8
    (``dtype`` is then ignored), else a :class:`KVCache`."""
    L = cfg.n_layers if n_layers is None else n_layers
    if cfg.sliding_window is not None:
        capacity = min(capacity, cfg.sliding_window)
    shape = (L, batch, capacity, cfg.n_kv_eff, cfg.hd)
    if cfg.kv_cache_dtype == "int8":
        return QuantKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device),
            length=torch.zeros((), dtype=torch.int32, device=device))
    dtype = dtype or cfg.tdtype
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((), dtype=torch.int32, device=device))


def cache_from_prefill(cfg: ModelConfig, k: Tensor, v: Tensor,
                       capacity: int):
    """Seed a decode cache with prefill K/V, stacked ``[L, B, S, nkv, hd]``:
    the positions :func:`seed_slots` keeps at their slots (the whole prompt
    at ``[0, S)``, or a ring's last ``C`` at ``p % C``), the rest zero. An
    int8 cache holds the kept positions' codes and scales, and elsewhere
    what the JAX package's quantised zero padding holds: codes 0, scales
    1e-8. Built without an indexed write (a gather of the kept positions
    in slot order, then the empty slots), so DTensor K/V give a cache
    with their placements."""
    L, B, S = k.shape[:3]
    C = capacity if cfg.sliding_window is None \
        else min(capacity, cfg.sliding_window)
    kept, slots = seed_slots(cfg, S, C)
    order = kept[torch.argsort(slots)].to(k.device)   # slot j: order[j]
    quant = cfg.kv_cache_dtype == "int8"
    fields = {}
    for name, rows in kv_fields(k.index_select(2, order),
                                v.index_select(2, order), quant):
        empty = list(rows.shape)
        empty[2] = C - order.numel()
        fill = 1e-8 if name.endswith("_scale") else 0
        fields[name] = rows if not empty[2] else torch.cat([rows, torch.full(
            empty, fill, dtype=rows.dtype, device=rows.device)], dim=2)
    length = torch.full((), S, dtype=torch.int32, device=k.device)
    return (QuantKVCache if quant else KVCache)(**fields, length=length)


def init_paged_cache(cfg: ModelConfig, batch: int, n_blocks: int,
                     block_size: int, n_bt: int, device,
                     dtype=None, n_layers: Optional[int] = None
                     ) -> PagedKVCache:
    """Zeroed paged pool (plus its trash block), all-sentinel block tables
    and zero positions, with ``n_layers`` layers (default
    ``cfg.n_layers``; the published Zamba2's pool has one per shared
    application). ``n_bt`` is the block-table width, the per-slot
    logical capacity in blocks. With an int8 KV cache the pools are int8
    and f32 scale pools of the same blocks (trash block included) come
    with them. A sliding window raises ``ValueError``: blocks are addressed
    by position, a ring by position modulo its capacity."""
    cfg.validate(paged=True)
    shape = (cfg.n_layers if n_layers is None else n_layers, n_blocks + 1,
             block_size, cfg.n_kv_eff, cfg.hd)
    quant = cfg.kv_cache_dtype == "int8"
    dtype = torch.int8 if quant else (dtype or cfg.tdtype)
    scales = {}
    if quant:
        scales = {name: torch.zeros(shape[:-1], dtype=torch.float32,
                                    device=device)
                  for name in ("k_scale", "v_scale")}
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        block_tables=torch.full((batch, n_bt), n_blocks, dtype=torch.int32,
                                device=device),
        length=torch.zeros(batch, dtype=torch.int32, device=device),
        **scales)


def _decode_valid(pos: Tensor, C: int, device,
                  window: Optional[int] = None) -> Tensor:
    """[1 or B, C] bool mask over cache slots (``pos`` a 0-d shared
    position, or a ``[B]`` tensor of per-row positions). Full attention:
    slots <= pos are filled. A ring (``window``): each slot's global
    position is rebuilt from the new token's slot ``pos % C``, and the
    slots holding positions in ``(pos - window, pos]`` are valid, as in
    the JAX package's ``_decode_valid``."""
    slots = torch.arange(C, device=device)[None]
    pos = pos.reshape(-1, 1)
    if window is None:
        return slots <= pos
    slot = pos % C
    kv_pos = pos - slot + slots - torch.where(slots <= slot, 0, C)
    return (kv_pos >= 0) & (kv_pos > pos - window)


def _decode_attend(cfg: ModelConfig, p: dict, q: Tensor, k: Tensor,
                   v: Tensor, valid: Tensor, force_ref: bool) -> Tensor:
    """Attend one query token over the cache and project out.
    q [B,1,nh,hd]; k/v [B,C,nkv,hd]; valid [B or 1, C]."""
    B, C = q.shape[0], k.shape[1]
    valid = valid.expand(B, C)
    if force_ref:
        out = _sdpa(cfg, q, k, v, valid[:, None, :])
    else:
        out = kops.decode_attention(q, k, v, valid, scale=cfg.attn_scale)
    return torch.matmul(merge_dims(out, 2, 3), p["wo"])


def _rope_positions(pos: Tensor) -> Tensor:
    """RoPE positions of the new token: [1] for a shared position, [B, 1]
    per row."""
    return pos.reshape(1) if pos.dim() == 0 else pos[:, None]


def _write_slot_sharded(buf: Tensor, layer: int, idx: Tensor,
                        new: Tensor) -> None:
    """``buf[layer].index_copy_(1, idx, new)`` for a DTensor cache: ``new``
    ([B, 1, ...]) laid out as the layer's slice of ``buf`` ([L, B, C, ...])
    and written into each rank's shard in place (DTensor has no in-place
    ``index_copy_`` rule in some PyTorch versions). A rank whose shard of
    a slot-split cache (``seq_sharded_cache``) does not hold the slot
    writes its own values back."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = buf.device_mesh
    pl = tuple(Shard(p.dim - 1) if p.is_shard() and p.dim != 2
               else Replicate() for p in buf.placements)
    local = buf.to_local()[layer]
    rows = new.redistribute(mesh, pl).to_local()
    if is_dtensor(idx):             # the position: replicated
        idx = idx.full_tensor()
    for i, p in enumerate(buf.placements):
        if p.is_shard(2):           # slots split: this rank's range
            n = local.shape[1]
            lo = mesh.get_local_rank(i) * n
            inside = (idx >= lo) & (idx < lo + n)
            idx = (idx - lo).clamp(0, n - 1)
            rows = torch.where(inside, rows, local.index_select(1, idx))
    local.index_copy_(1, idx, rows)


def attn_decode_stacked(cfg: ModelConfig, p: dict, x: Tensor, kv,
                        pos: Tensor, layer: int,
                        force_ref: bool = False) -> Tensor:
    """One-token step writing straight into the STACKED cache.

    x [B,1,d]; ``kv`` a stacked :class:`KVCache` or :class:`QuantKVCache`;
    ``pos`` is the new token's position, an int32 tensor: 0-d and shared
    by every row, or ``[B]``, one per row. The JAX package's
    ``dynamic_update_slice`` at a traced position becomes an in-place write
    into ``kv.k[layer, :, slot]``; like that op, a shared position past the
    capacity writes the last slot. Its per-row scatter drops a row whose
    position is past the capacity (a retired row riding a chunk); here that
    row's slot index is clamped and its old value written back (codes and
    scales alike). A ring (sliding window) writes slot ``pos % C``, never
    past its capacity. An int8 cache gets the new token's codes and scales,
    and the layer is dequantised to the activation dtype before the
    attend. No device-to-host read happens here (the slot is an index
    tensor, never a host int), so the step can be captured in a CUDA
    graph. Returns y [B,1,d]; the caller owns the position.
    """
    q, k_new, v_new = _project_qkv(cfg, p, x, _rope_positions(pos))
    quant = isinstance(kv, QuantKVCache)
    pairs = [(getattr(kv, name), new)
             for name, new in kv_fields(k_new, v_new, quant)]
    C, window = kv.capacity, cfg.sliding_window
    slot = pos.clamp(max=C - 1) if window is None else pos % C
    if pos.dim() == 0:
        idx = slot.reshape(1).long()
        for buf, new in pairs:
            if is_dtensor(buf):
                _write_slot_sharded(buf, layer, idx, new)
            else:
                buf[layer].index_copy_(1, idx, new)
    else:
        rows = torch.arange(x.shape[0], device=x.device)
        for buf, new in pairs:
            new = new[:, 0]
            if window is None:       # a row past the capacity keeps its own
                old = buf[layer, rows, slot]
                past = (pos >= C).reshape((-1,) + (1,) * (old.dim() - 1))
                new = torch.where(past, old, new)
            buf[layer, rows, slot] = new
    if quant:
        k = _dequantize(kv.k[layer], kv.k_scale[layer], x.dtype)
        v = _dequantize(kv.v[layer], kv.v_scale[layer], x.dtype)
    else:
        k, v = kv.k[layer], kv.v[layer]
    valid = _decode_valid(pos, C, x.device, window)
    return _decode_attend(cfg, p, q, k, v, valid, force_ref)


def attn_decode_paged(cfg: ModelConfig, p: dict, x: Tensor,
                      pc: PagedKVCache, pos: Tensor, layer: int,
                      force_ref: bool = False) -> Tensor:
    """One-token step against the paged block pool.

    x [B,1,d]; ``pos`` [B] int32 the per-slot positions. The new token's
    K/V (an int8 pool: its codes and scales) is written in place at
    ``pool[layer, block_tables[b, pos // bs], pos % bs]``; a position past
    the block table, or behind a sentinel entry, writes the trash block
    (the JAX package drops those writes). A full-precision pool attends
    with ``paged_decode_attention`` over the pool directly (the Hopper
    kernel on a CUDA device, its plain version on the CPU). An int8 pool,
    and ``force_ref=True``, take the JAX package's gather path instead:
    gather the slot's blocks into the dense ``[B, C, nkv, hd]`` layout
    (sentinels clipped to a real block, hidden by the ``slots <= pos``
    mask), dequantise an int8 pool, and reuse the slot attend (the slot
    decode kernel, or with ``force_ref`` its reference). Returns
    y [B,1,d].
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
    quant = pc.k_scale is not None
    for name, new in kv_fields(k_new, v_new, quant):
        getattr(pc, name)[layer, blk, off] = new[:, 0]
    if not (force_ref or quant):
        out = kops.paged_decode_attention(q, pc.k[layer, :P], pc.v[layer, :P],
                                          pc.block_tables, pos,
                                          scale=cfg.attn_scale)
        return torch.matmul(merge_dims(out, 2, 3), p["wo"])
    # the JAX package's gather path masks by position only: a sentinel
    # entry reads a clipped real block, hidden because it lies past pos
    k, v, _ = kops.paged_gather(pc.k[layer, :P], pc.v[layer, :P],
                                pc.block_tables, pos)
    if quant:
        ks, vs, _ = kops.paged_gather(pc.k_scale[layer, :P, ..., None],
                                      pc.v_scale[layer, :P, ..., None],
                                      pc.block_tables, pos)
        k = _dequantize(k, ks[..., 0], x.dtype)
        v = _dequantize(v, vs[..., 0], x.dtype)
    return _decode_attend(cfg, p, q, k, v,
                          _decode_valid(pos, k.shape[1], x.device),
                          force_ref)
