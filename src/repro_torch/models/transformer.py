"""Model assembly for the dense decoder (the ``"attn"`` block kind).

Parameters are a plain dict of tensors with the JAX package's tree layout:
per-block leaves are stacked on a leading layer axis (``[L, ...]``), so
``repro_torch.weights.from_jax_params`` carries a JAX tree across as is.
The JAX package scanned the stack with ``lax.scan``; here the layers run
in a Python loop over views of the stacked leaves.

Entry points:
    init_params(cfg, seed, device)
    forward(cfg, params, tokens, return_cache=False, cache_capacity=None)
    decode_step(cfg, params, token, cache)   # slot or paged cache
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..compat import DEFAULT_DEVICE, resolve_device
from . import attention
from .attention import PagedKVCache
from .config import ModelConfig
from .layers import (apply_mlp, apply_norm, embed_tokens, init_embed,
                     init_mlp, init_norm, lm_head)

Tensor = torch.Tensor


class ModelOutput(NamedTuple):
    logits: Tensor
    cache: Any               # decode cache or None


def init_params(cfg: ModelConfig, seed: int = 0,
                device=DEFAULT_DEVICE) -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``, on
    ``device``, with the JAX package's ``_he`` scales. (``jax.random`` draws
    other numbers from the same seed; the parity tests carry the JAX
    package's parameters across with ``from_jax_params`` instead.)"""
    cfg.validate()
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lead = (cfg.n_layers,)
    return {
        "embed": init_embed(cfg, gen),
        "blocks": {"ln1": init_norm(cfg, lead, dev),
                   "attn": attention.init_attn(cfg, gen, lead),
                   "ln2": init_norm(cfg, lead, dev),
                   "mlp": init_mlp(cfg, gen, lead)},
        "final_norm": init_norm(cfg, (), dev),
    }


def _layer_at(tree, i: int):
    """Per-layer view of the stacked parameter leaves."""
    if isinstance(tree, dict):
        return {k: _layer_at(v, i) for k, v in tree.items()}
    return tree[i]


def _block_forward(cfg: ModelConfig, p: dict, x: Tensor, positions: Tensor,
                   force_ref: bool):
    h, kv = attention.attn_forward(cfg, p["attn"],
                                   apply_norm(cfg, p["ln1"], x), positions,
                                   force_ref=force_ref)
    x = x + h
    x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x),
                      force_ref=force_ref)
    return x, kv


def forward(cfg: ModelConfig, params: dict, tokens: Tensor,
            return_cache: bool = False,
            cache_capacity: Optional[int] = None,
            force_ref: bool = False) -> ModelOutput:
    """tokens [B, S] -> logits [B, S, V].

    ``return_cache`` returns ``{"layers": (k, v)}`` stacked
    ``[L, B, S, nkv, hd]``, or ``{"layers": KVCache}`` seeded at capacity
    ``cache_capacity`` when given. ``force_ref`` runs the JAX package's
    reference math in place of the kernels.
    """
    x = embed_tokens(cfg, params["embed"], tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _block_forward(cfg, _layer_at(params["blocks"], i), x,
                                   positions, force_ref)
        if return_cache:
            ks.append(k)
            vs.append(v)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_head(cfg, params["embed"], x)
    cache = None
    if return_cache:
        cache = {"layers": (torch.stack(ks), torch.stack(vs))}
        if cache_capacity is not None:
            cache = _seed_cache(cfg, cache, cache_capacity)
    return ModelOutput(logits=logits, cache=cache)


def _seed_cache(cfg: ModelConfig, cache: dict, capacity: int) -> dict:
    """Prefill K/V ``[L, B, S, ..]`` -> fixed-capacity decode cache."""
    k, v = cache["layers"]
    return {"layers": attention.cache_from_prefill(cfg, k, v, capacity)}


def decode_step(cfg: ModelConfig, params: dict, token: Tensor, cache: dict,
                force_ref: bool = False) -> ModelOutput:
    """token [B, 1] -> next-token logits [B, 1, V].

    The counterpart of the JAX package's ``decode_step(static_layers=True)``:
    a loop over layers that writes each layer's new K/V in place into the
    cache leaves, dispatching on the cache type as ``_attn_block_static``
    does: a stacked :class:`KVCache` (one position for the batch, or one
    per row) or a :class:`PagedKVCache`. The returned cache shares those
    tensors, with its position advanced by one.
    """
    kv = cache["layers"]
    pos = kv.length
    attend = (attention.attn_decode_paged if isinstance(kv, PagedKVCache)
              else attention.attn_decode_stacked)
    x = embed_tokens(cfg, params["embed"], token)
    for i in range(cfg.n_layers):
        p = _layer_at(params["blocks"], i)
        x = x + attend(cfg, p["attn"], apply_norm(cfg, p["ln1"], x), kv, pos,
                       i, force_ref=force_ref)
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x),
                          force_ref=force_ref)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_head(cfg, params["embed"], x)
    return ModelOutput(logits=logits, cache={"layers": kv._replace(
        length=pos + 1)})
