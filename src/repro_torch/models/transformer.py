"""Model assembly for the ported families.

Block kinds: ``"attn"`` (the dense decoder, with the config's norm, MLP
and attention window), ``"rwkv6"`` (the recurrent ``ssm`` family) and
``"mamba2"`` (the hybrid's backbone). The hybrid
(Zamba2-style) stack runs ``g = n_layers // attn_every`` groups of
``attn_every`` Mamba2 layers, each followed by ONE application of a
weight-shared attention+MLP block (``params["shared_attn"]``, unstacked),
then the ``n_layers % attn_every`` remaining Mamba2 layers; each
application of the shared block has its own KV cache (weights shared,
activations not).

Parameters are a plain dict of tensors with the JAX package's tree layout:
per-block leaves are stacked on a leading layer axis (``[L, ...]``), so
``repro_torch.weights.from_jax_params`` carries a JAX tree across as is.
The JAX package scanned the stack with ``lax.scan``; here the layers run
in a Python loop over views of the stacked leaves, and decode updates the
stacked caches in place (the JAX package's ``decode_step(static_layers=
True)``).

Entry points:
    init_params(cfg, seed, device)
    forward(cfg, params, tokens, return_cache=False, cache_capacity=None)
    decode_step(cfg, params, token, cache)   # slot, paged or recurrent
    init_decode_cache(cfg, batch, capacity, device)
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..compat import DEFAULT_DEVICE, resolve_device
from . import attention, mamba2, rwkv6
from .attention import PagedKVCache
from .config import ModelConfig
from .layers import (apply_mlp, apply_norm, embed_tokens, init_embed,
                     init_mlp, init_norm, lm_head)
from .mamba2 import MambaCache
from .rwkv6 import RWKVCache

Tensor = torch.Tensor


class ModelOutput(NamedTuple):
    logits: Tensor
    cache: Any               # decode cache or None


def _init_block(cfg: ModelConfig, kind: str, gen: torch.Generator,
                lead: tuple, dev) -> dict:
    if kind == "attn":
        return {"ln1": init_norm(cfg, lead, dev),
                "attn": attention.init_attn(cfg, gen, lead),
                "ln2": init_norm(cfg, lead, dev),
                "mlp": init_mlp(cfg, gen, lead)}
    if kind == "mamba2":
        return {"ln1": init_norm(cfg, lead, dev),
                "mamba": mamba2.init_mamba2(cfg, gen, lead)}
    if kind == "rwkv6":
        return {"ln1": init_norm(cfg, lead, dev),
                "ln2": init_norm(cfg, lead, dev),
                "rwkv": rwkv6.init_rwkv6(cfg, gen, lead)}
    raise ValueError(f"unknown block kind {kind!r}")


def init_params(cfg: ModelConfig, seed: int = 0,
                device=DEFAULT_DEVICE) -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``, on
    ``device``, with the JAX package's ``_he`` scales. (``jax.random`` draws
    other numbers from the same seed; the parity tests carry the JAX
    package's parameters across with ``from_jax_params`` instead.)"""
    cfg.validate()
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {
        "embed": init_embed(cfg, gen),
        "blocks": _init_block(cfg, cfg.backbone_kind, gen, (cfg.n_layers,),
                              dev),
        "final_norm": init_norm(cfg, (), dev),
    }
    if cfg.has_shared_attn:
        params["shared_attn"] = _init_block(cfg, "attn", gen, (), dev)
    return params


def _layer_at(tree, *idx):
    """Per-layer view of stacked parameter leaves or recurrent cache leaves
    (a host int such as a cache's ``length`` is shared by all layers)."""
    if isinstance(tree, dict):
        return {k: _layer_at(v, *idx) for k, v in tree.items()}
    if isinstance(tree, (RWKVCache, MambaCache)):
        return type(tree)(*(_layer_at(v, *idx) for v in tree))
    if isinstance(tree, Tensor):
        return tree[idx]
    return tree


def _stack(seeds: list):
    """Per-layer prefill cache seeds -> one seed stacked on a new leading
    axis: (k, v) pairs and recurrent caches leaf by leaf."""
    first = seeds[0]
    if isinstance(first, (RWKVCache, MambaCache)):
        return type(first)(*(torch.stack(f) if isinstance(f[0], Tensor)
                             else f[0] for f in zip(*seeds)))
    return tuple(torch.stack(f) for f in zip(*seeds))


def _hybrid_layout(cfg: ModelConfig):
    return cfg.n_layers // cfg.attn_every, cfg.n_layers % cfg.attn_every


def _block_forward(cfg: ModelConfig, kind: str, p: dict, x: Tensor,
                   positions: Tensor, force_ref: bool):
    """Full-sequence block. Returns (x, cache seed)."""
    if kind == "attn":
        h, kv = attention.attn_forward(cfg, p["attn"],
                                       apply_norm(cfg, p["ln1"], x),
                                       positions, force_ref=force_ref)
        x = x + h
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x),
                          force_ref=force_ref)
        return x, kv
    if kind == "mamba2":
        h, cache = mamba2.mamba2_forward(cfg, p["mamba"],
                                         apply_norm(cfg, p["ln1"], x),
                                         force_ref=force_ref)
        return x + h, cache
    if kind == "rwkv6":
        zp = torch.zeros(x.shape[0], cfg.d_model, dtype=x.dtype,
                         device=x.device)
        h, st, last_tm = rwkv6.rwkv6_time_mix(
            cfg, p["rwkv"], apply_norm(cfg, p["ln1"], x), zp,
            force_ref=force_ref)
        x = x + h
        h, last_cm = rwkv6.rwkv6_channel_mix(
            cfg, p["rwkv"], apply_norm(cfg, p["ln2"], x), zp)
        return x + h, RWKVCache(shift_tm=last_tm, shift_cm=last_cm, wkv=st,
                                length=x.shape[1])
    raise ValueError(f"unknown block kind {kind!r}")


def forward(cfg: ModelConfig, params: dict, tokens: Tensor,
            return_cache: bool = False,
            cache_capacity: Optional[int] = None,
            force_ref: bool = False) -> ModelOutput:
    """tokens [B, S] -> logits [B, S, V].

    ``return_cache`` returns the decode seeds stacked on the layer axes:
    ``{"layers": (k, v)}`` ``[L, B, S, nkv, hd]`` (dense),
    ``{"layers": RWKVCache}`` (recurrent), or for the hybrid
    ``{"grouped": MambaCache [g, attn_every, ...], "shared": (k, v)
    [g, ...], "remainder": MambaCache [rem, ...]}`` (``None`` where a part
    is empty). With ``cache_capacity`` the K/V seeds become
    fixed-capacity ``KVCache``s (``QuantKVCache``s when the config's KV
    cache is int8). ``force_ref`` runs the JAX package's reference math in
    place of the kernels.
    """
    x = embed_tokens(cfg, params["embed"], tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    kind = cfg.backbone_kind

    def block(i, x):
        return _block_forward(cfg, kind, _layer_at(params["blocks"], i), x,
                              positions, force_ref)

    cache = None
    if not cfg.has_shared_attn:
        seeds = []
        for i in range(cfg.n_layers):
            x, seed = block(i, x)
            if return_cache:
                seeds.append(seed)
        if return_cache:
            cache = {"layers": _stack(seeds)}
    else:
        g, rem = _hybrid_layout(cfg)
        grouped, shared, remainder = [], [], []
        for gi in range(g):
            row = []
            for j in range(cfg.attn_every):
                x, seed = block(gi * cfg.attn_every + j, x)
                row.append(seed)
            x, kv = _block_forward(cfg, "attn", params["shared_attn"], x,
                                   positions, force_ref)
            if return_cache:
                grouped.append(_stack(row))
                shared.append(kv)
        for j in range(rem):
            x, seed = block(g * cfg.attn_every + j, x)
            remainder.append(seed)
        if return_cache:
            cache = {"grouped": _stack(grouped) if g else None,
                     "shared": _stack(shared) if g else None,
                     "remainder": _stack(remainder) if rem else None}
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_head(cfg, params["embed"], x)
    if return_cache and cache_capacity is not None:
        cache = _seed_cache(cfg, cache, cache_capacity)
    return ModelOutput(logits=logits, cache=cache)


def _seed_cache(cfg: ModelConfig, cache: dict, capacity: int) -> dict:
    """Prefill K/V ``[L, B, S, ..]`` -> fixed-capacity decode caches; the
    recurrent states are decode caches already."""
    key = "shared" if cfg.has_shared_attn else "layers"
    if cfg.has_shared_attn or cfg.backbone_kind == "attn":
        if cache[key] is not None:
            k, v = cache[key]
            cache = {**cache, key: attention.cache_from_prefill(cfg, k, v,
                                                                capacity)}
    return cache


def init_decode_cache(cfg: ModelConfig, batch: int, capacity: int,
                      device=DEFAULT_DEVICE) -> dict:
    """Zeroed decode caches at position 0, in ``forward``'s layout."""
    dev = resolve_device(device)
    kind = cfg.backbone_kind
    if not cfg.has_shared_attn:
        if kind == "attn":
            return {"layers": attention.init_cache(cfg, batch, capacity,
                                                   dev)}
        make = (rwkv6.init_rwkv_cache if kind == "rwkv6"
                else mamba2.init_mamba_cache)
        return {"layers": make(cfg, batch, dev, lead=(cfg.n_layers,))}
    g, rem = _hybrid_layout(cfg)
    return {
        "grouped": (mamba2.init_mamba_cache(cfg, batch, dev,
                                            lead=(g, cfg.attn_every))
                    if g else None),
        "shared": (attention.init_cache(cfg, batch, capacity, dev,
                                        n_layers=g) if g else None),
        "remainder": (mamba2.init_mamba_cache(cfg, batch, dev, lead=(rem,))
                      if rem else None),
    }


def _attn_block_decode(cfg: ModelConfig, p: dict, x: Tensor, kv, pos,
                       layer: int, force_ref: bool) -> Tensor:
    """Attention block step writing K/V in place into layer ``layer`` of the
    stacked slot cache (``KVCache`` or ``QuantKVCache``) or the paged
    pool."""
    attend = (attention.attn_decode_paged if isinstance(kv, PagedKVCache)
              else attention.attn_decode_stacked)
    x = x + attend(cfg, p["attn"], apply_norm(cfg, p["ln1"], x), kv, pos,
                   layer, force_ref=force_ref)
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x),
                         force_ref=force_ref)


def _recurrent_decode(cfg: ModelConfig, kind: str, p: dict, x: Tensor,
                      stacked, *idx) -> Tensor:
    """Recurrent block step; the new state is copied in place into the
    stacked cache leaves at ``idx``."""
    c = _layer_at(stacked, *idx)
    if kind == "mamba2":
        h, new = mamba2.mamba2_decode(cfg, p["mamba"],
                                      apply_norm(cfg, p["ln1"], x), c)
        x = x + h
    else:
        x1 = x[:, 0, :]
        h, st, tm = rwkv6.rwkv6_time_mix_decode(
            cfg, p["rwkv"], apply_norm(cfg, p["ln1"], x)[:, 0, :], c.wkv,
            c.shift_tm)
        x1 = x1 + h
        h, cm = rwkv6.rwkv6_channel_mix_decode(
            cfg, p["rwkv"], apply_norm(cfg, p["ln2"], x1[:, None, :])[:, 0],
            c.shift_cm)
        x = (x1 + h)[:, None, :]
        new = RWKVCache(shift_tm=tm, shift_cm=cm, wkv=st, length=c.length)
    for dst, src in zip(c, new):
        if isinstance(dst, Tensor):
            dst.copy_(src)
    return x


def _advance(cache):
    """Advance a cache's positions by one: a KV cache's length tensor in
    place, so a replayed CUDA graph of the step moves the live positions;
    the recurrent caches' host-int ``length`` (no decode op reads it)
    through a new tuple around the same state tensors."""
    if cache is None:
        return None
    if isinstance(cache.length, Tensor):
        cache.length.add_(1)
        return cache
    return cache._replace(length=cache.length + 1)


def decode_step(cfg: ModelConfig, params: dict, token: Tensor, cache: dict,
                force_ref: bool = False) -> ModelOutput:
    """token [B, 1] -> next-token logits [B, 1, V].

    The counterpart of the JAX package's ``decode_step(static_layers=True)``:
    a loop over layers that updates the cache leaves in place. The dense
    stack dispatches on the cache type as ``_attn_block_static`` does: a
    stacked :class:`KVCache` or int8 :class:`QuantKVCache` (one position
    for the batch, or one per row) or a :class:`PagedKVCache` (full
    precision or int8). Recurrent states are copied into their
    stacked leaves; the hybrid's shared block attends over application
    ``gi`` of its stacked ``KVCache``. The KV caches' positions advance in
    place, so the returned cache is the argument's own KV cache objects;
    it shares every state tensor, with its positions advanced by one. No
    op reads a tensor on the host, so the step can be captured in a CUDA
    graph.
    """
    x = embed_tokens(cfg, params["embed"], token)
    blocks, kind = params["blocks"], cfg.backbone_kind
    if not cfg.has_shared_attn:
        layers = cache["layers"]
        for i in range(cfg.n_layers):
            p = _layer_at(blocks, i)
            if kind == "attn":
                x = _attn_block_decode(cfg, p, x, layers, layers.length, i,
                                       force_ref)
            else:
                x = _recurrent_decode(cfg, kind, p, x, layers, i)
        new_cache = {"layers": _advance(layers)}
    else:
        g, rem = _hybrid_layout(cfg)
        grouped, shared = cache["grouped"], cache["shared"]
        remainder = cache["remainder"]
        for gi in range(g):
            for j in range(cfg.attn_every):
                x = _recurrent_decode(
                    cfg, kind, _layer_at(blocks, gi * cfg.attn_every + j), x,
                    grouped, gi, j)
            x = _attn_block_decode(cfg, params["shared_attn"], x, shared,
                                   shared.length, gi, force_ref)
        for j in range(rem):
            x = _recurrent_decode(
                cfg, kind, _layer_at(blocks, g * cfg.attn_every + j), x,
                remainder, j)
        new_cache = {"grouped": _advance(grouped), "shared": _advance(shared),
                     "remainder": _advance(remainder)}
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_head(cfg, params["embed"], x)
    return ModelOutput(logits=logits, cache=new_cache)
