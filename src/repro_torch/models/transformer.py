"""Model assembly for the ported families.

Block kinds: ``"attn"`` (the dense decoder, with the config's norm, MLP
and attention window), ``"moe"`` (the same attention with the routed and
shared experts of ``models/moe.py`` in place of the MLP; its K/V caches,
slot or paged, are the dense decoder's), ``"rwkv6"`` (the recurrent
``ssm`` family) and ``"mamba2"`` (the hybrid's backbone). The hybrid
(Zamba2-style) stack runs ``g = n_layers // attn_every`` groups of
``attn_every`` Mamba2 layers, each followed by ONE application of a
weight-shared attention+MLP block (``params["shared_attn"]``, unstacked),
then the ``n_layers % attn_every`` remaining Mamba2 layers; each
application of the shared block has its own KV cache (weights shared,
activations not). The hybrid as Zamba2 publishes it
(:class:`~.config.Zamba2Config`, ``models/zamba2.py``) places its shared
applications by ``hybrid_layer_ids`` instead: before each such Mamba2
layer, block ``j % num_mem_blocks`` reads ``[h, x0]`` and its output goes
into that layer's input, ``h <- h + Mamba(RMSNorm(h + t))``. Its cache is
``{"mamba": MambaCache [L, ...], "shared": K/V of the A applications}``:
a stacked ``KVCache`` or a ``PagedKVCache`` pool of A layers.

Parameters are a plain dict of tensors with the JAX package's tree layout:
per-block leaves are stacked on a leading layer axis (``[L, ...]``), so
``repro_torch.weights.from_jax_params`` carries a JAX tree across as is.
The JAX package scanned the stack with ``lax.scan``; here the layers run
in a Python loop over views of the stacked leaves, and decode updates the
stacked caches in place (the JAX package's ``decode_step(static_layers=
True)``).

Entry points:
    init_params(cfg, seed, device)
    forward(cfg, params, tokens, prefix_embeds=None, return_cache=False,
            cache_capacity=None)
    decode_step(cfg, params, token, cache)   # slot, paged or recurrent
    init_decode_cache(cfg, batch, capacity, device)
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..compat import DEFAULT_DEVICE, resolve_device
from ..sharding.context import get_mesh
from . import attention, mamba2, moe, rwkv6, zamba2
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
    # forward: the MoE load-balance aux loss summed over the layers, an f32
    # scalar (0 for the other families); decode_step computes none
    aux_loss: Optional[Tensor] = None


def _init_block(cfg: ModelConfig, kind: str, gen: torch.Generator,
                lead: tuple, dev) -> dict:
    if kind == "attn":
        return {"ln1": init_norm(cfg, lead, dev),
                "attn": attention.init_attn(cfg, gen, lead),
                "ln2": init_norm(cfg, lead, dev),
                "mlp": init_mlp(cfg, gen, lead)}
    if kind == "moe":
        return {"ln1": init_norm(cfg, lead, dev),
                "attn": attention.init_attn(cfg, gen, lead),
                "ln2": init_norm(cfg, lead, dev),
                "moe": moe.init_moe(cfg, gen, lead)}
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
    if cfg.published_hybrid:
        params["shared"], params["apps"] = zamba2.init_shared(cfg, gen, dev)
    elif cfg.has_shared_attn:
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


def _block_ffn(cfg: ModelConfig, p: dict, x: Tensor, force_ref: bool):
    """An attention block's FFN on its normed input: the MLP, or the MoE
    (``p["moe"]``). Returns (h, aux loss or None)."""
    if "moe" in p:
        return moe.moe_forward(cfg, p["moe"], x, force_ref=force_ref)
    return apply_mlp(cfg, p["mlp"], x, force_ref=force_ref), None


def _block_ffn_decode(cfg: ModelConfig, p: dict, x: Tensor,
                      force_ref: bool) -> Tensor:
    """``_block_ffn`` of a decode step, which has no use for the MoE's aux
    loss and so does not compute it (but under a mesh, where the sharded
    dispatch computes it, as the JAX package's decode step does)."""
    if "moe" in p:
        if get_mesh() is not None:
            return moe.moe_forward(cfg, p["moe"], x, force_ref=force_ref)[0]
        return moe.moe_apply(cfg, p["moe"], x, force_ref=force_ref)[0]
    return apply_mlp(cfg, p["mlp"], x, force_ref=force_ref)


def _block_forward(cfg: ModelConfig, kind: str, p: dict, x: Tensor,
                   positions: Tensor, force_ref: bool):
    """Full-sequence block. Returns (x, cache seed, aux loss or None)."""
    if kind in ("attn", "moe"):
        h, kv = attention.attn_forward(cfg, p["attn"],
                                       apply_norm(cfg, p["ln1"], x),
                                       positions, force_ref=force_ref)
        x = x + h
        h, aux = _block_ffn(cfg, p, apply_norm(cfg, p["ln2"], x), force_ref)
        return x + h, kv, aux
    if kind == "mamba2":
        h, cache = mamba2.mamba2_forward(cfg, p["mamba"],
                                         apply_norm(cfg, p["ln1"], x),
                                         force_ref=force_ref)
        return x + h, cache, None
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
                                length=x.shape[1]), None
    raise ValueError(f"unknown block kind {kind!r}")


def _records_grad(params: dict, x: Tensor) -> bool:
    """Whether this forward builds an autograd graph: grad mode on and the
    input or a block parameter requiring grad (serves hold parameters that
    do not, so remat never wraps a serve's blocks)."""
    if not torch.is_grad_enabled():
        return False
    if x.requires_grad:
        return True
    stack = [params["blocks"], params.get("shared_attn", {})]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, Tensor) and node.requires_grad:
            return True
    return False


def _remat(fn):
    """``fn`` under activation checkpointing: its activations are dropped
    after the forward and recomputed in the backward pass."""
    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return wrapped


def forward(cfg: ModelConfig, params: dict, tokens: Tensor,
            prefix_embeds: Optional[Tensor] = None,
            return_cache: bool = False,
            cache_capacity: Optional[int] = None,
            force_ref: bool = False,
            last_logits_only: bool = False) -> ModelOutput:
    """tokens [B, S] -> logits [B, P + S, V] (``last_logits_only``: the
    last position's, [B, 1, V], the only ones a prefill serves; the JAX
    package slices the full logits and XLA computes only that row).

    ``prefix_embeds`` ``[B, P, d]`` (the VLM and audio families' stubbed
    frontend: image patches or conditioning frames at ``d_model``) go in
    front of the token embeddings, cast to their dtype; positions run over
    all ``P + S`` rows, and so do the logits and the cache (callers slice
    the logits).
    ``return_cache`` returns the decode seeds stacked on the layer axes:
    ``{"layers": (k, v)}`` ``[L, B, S, nkv, hd]`` (dense and MoE),
    ``{"layers": RWKVCache}`` (recurrent), or for the hybrid
    ``{"grouped": MambaCache [g, attn_every, ...], "shared": (k, v)
    [g, ...], "remainder": MambaCache [rem, ...]}`` (``None`` where a part
    is empty). With ``cache_capacity`` the K/V seeds become
    fixed-capacity ``KVCache``s (``QuantKVCache``s when the config's KV
    cache is int8). ``force_ref`` runs the JAX package's reference math in
    place of the kernels. ``aux_loss`` sums the MoE layers' load-balance
    losses (0 for the other families). With ``cfg.remat`` a forward that
    records gradients checkpoints each block (with ``remat_group``, the
    hybrid's groups of ``attn_every`` blocks plus the shared block) and
    recomputes it in the backward pass, as the JAX package's
    ``jax.checkpoint`` does; a forward that records none runs as is.
    """
    x = embed_tokens(cfg, params["embed"], tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    kind = cfg.backbone_kind
    remat = cfg.remat and _records_grad(params, x)
    group_remat = remat and cfg.has_shared_attn and cfg.remat_group

    def run_block(kind_, p, x):
        return _block_forward(cfg, kind_, p, x, positions, force_ref)

    block_fn = _remat(run_block) if remat and not group_remat else run_block
    aux_parts = []

    def block(i, x):
        x, seed, aux = block_fn(kind, _layer_at(params["blocks"], i), x)
        if aux is not None:
            aux_parts.append(aux)
        return x, seed

    cache = None
    if cfg.published_hybrid:
        x, cache = _published_forward(cfg, params, x, positions, force_ref)
        cache = cache if return_cache else None
    elif not cfg.has_shared_attn:
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

        def group(gi, x):
            row = []
            for j in range(cfg.attn_every):
                x, seed = block(gi * cfg.attn_every + j, x)
                row.append(seed)
            x, kv, _ = block_fn("attn", params["shared_attn"], x)
            return x, row, kv

        group_fn = _remat(group) if group_remat else group
        for gi in range(g):
            x, row, kv = group_fn(gi, x)
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
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for aux in aux_parts:
        aux_total = aux_total + aux
    if last_logits_only:
        x = x[:, -1:]
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_head(cfg, params["embed"], x)
    if return_cache and cache_capacity is not None:
        cache = _seed_cache(cfg, cache, cache_capacity)
    return ModelOutput(logits=logits, cache=cache, aux_loss=aux_total)


def _apps_at(cfg: ModelConfig) -> dict:
    """Mamba2 layer -> the shared application that precedes it."""
    return {i: j for j, i in enumerate(cfg.hybrid_layer_ids)}


def _published_forward(cfg: ModelConfig, params: dict, x0: Tensor,
                       positions: Tensor, force_ref: bool) -> tuple:
    """The published Zamba2 stack over the embedded sequence ``x0``:
    (h before the final norm, the cache seeds ``{"mamba": MambaCache
    [L, ...], "shared": (k, v) [A, B, S, nkv, hd]}``)."""
    apps = _apps_at(cfg)
    h, seeds, kvs = x0, [], []
    for i in range(cfg.n_layers):
        p = _layer_at(params["blocks"], i)
        inp = h
        if i in apps:
            t, kv = zamba2.shared_forward(cfg, params, apps[i], h, x0,
                                          positions, force_ref)
            inp = h + t
            kvs.append(kv)
        y, seed = mamba2.mamba2_forward(cfg, p["mamba"],
                                        apply_norm(cfg, p["ln1"], inp),
                                        force_ref=force_ref)
        h = h + y
        seeds.append(seed)
    return h, {"mamba": _stack(seeds), "shared": _stack(kvs)}


def _seed_cache(cfg: ModelConfig, cache: dict, capacity: int) -> dict:
    """Prefill K/V ``[L, B, S, ..]`` -> fixed-capacity decode caches; the
    recurrent states are decode caches already."""
    key = "shared" if cfg.has_shared_attn else "layers"
    if cfg.has_shared_attn or cfg.has_attn_layers:
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
    if cfg.published_hybrid:
        return {"mamba": mamba2.init_mamba_cache(cfg, batch, dev,
                                                 lead=(cfg.n_layers,)),
                "shared": attention.init_cache(cfg, batch, capacity, dev,
                                               n_layers=cfg.n_apps)}
    if not cfg.has_shared_attn:
        if cfg.has_attn_layers:
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
    """Attention block step (dense or MoE) writing K/V in place into layer
    ``layer`` of the stacked slot cache (``KVCache`` or ``QuantKVCache``)
    or the paged pool."""
    attend = (attention.attn_decode_paged if isinstance(kv, PagedKVCache)
              else attention.attn_decode_stacked)
    x = x + attend(cfg, p["attn"], apply_norm(cfg, p["ln1"], x), kv, pos,
                   layer, force_ref=force_ref)
    return x + _block_ffn_decode(cfg, p, apply_norm(cfg, p["ln2"], x),
                                 force_ref)


def _recurrent_decode(cfg: ModelConfig, kind: str, p: dict, x: Tensor,
                      stacked, *idx, inject: Optional[Tensor] = None
                      ) -> Tensor:
    """Recurrent block step; the new state is copied in place into the
    stacked cache leaves at ``idx``. ``inject`` (the published Zamba2's
    shared output) is added to a Mamba2 layer's input, not to ``x``."""
    c = _layer_at(stacked, *idx)
    if kind == "mamba2":
        inp = x if inject is None else x + inject
        h, new = mamba2.mamba2_decode(cfg, p["mamba"],
                                      apply_norm(cfg, p["ln1"], inp), c)
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
    if cfg.published_hybrid:
        x, new_cache = _published_decode(cfg, params, x, cache, force_ref)
    elif not cfg.has_shared_attn:
        layers = cache["layers"]
        for i in range(cfg.n_layers):
            p = _layer_at(blocks, i)
            if cfg.has_attn_layers:
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


def _published_decode(cfg: ModelConfig, params: dict, x0: Tensor,
                      cache: dict, force_ref: bool) -> tuple:
    """One token through the published Zamba2 stack: the Mamba2 states
    copied in place, each application's K/V written into its layer of
    ``cache["shared"]`` (slot cache or paged pool); the phase marks of
    :func:`zamba2.timing_phases` at each switch between the two."""
    apps = _apps_at(cfg)
    mamba, shared = cache["mamba"], cache["shared"]
    h = x0
    zamba2.mark("mamba")
    for i in range(cfg.n_layers):
        inject = None
        if i in apps:
            zamba2.mark("shared")
            inject = zamba2.shared_decode(cfg, params, apps[i], h, x0,
                                          shared, force_ref)
            zamba2.mark("mamba")
        h = _recurrent_decode(cfg, "mamba2", _layer_at(params["blocks"], i),
                              h, mamba, i, inject=inject)
    zamba2.mark("end")
    return h, {"mamba": _advance(mamba), "shared": _advance(shared)}


def init_paged_decode_cache(cfg: ModelConfig, batch: int, n_blocks: int,
                            block_size: int, n_bt: int, device) -> dict:
    """The paged continuous engine's cache: the dense stack's pool under
    ``"layers"``, or for the published Zamba2 the applications' pool under
    ``"shared"`` beside every layer's per-row Mamba2 state."""
    if not cfg.published_hybrid:
        return {"layers": attention.init_paged_cache(
            cfg, batch, n_blocks, block_size, n_bt, device)}
    return {"mamba": mamba2.init_mamba_cache(cfg, batch, device,
                                             lead=(cfg.n_layers,)),
            "shared": attention.init_paged_cache(
                cfg, batch, n_blocks, block_size, n_bt, device,
                n_layers=cfg.n_apps)}
