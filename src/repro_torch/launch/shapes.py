"""Assigned input shapes and shape-only stand-ins for the dry-run
(``repro.launch.shapes``).

Four global shapes (assigned with the paper):

    train_4k      seq=4,096    global_batch=256   train_step
    prefill_32k   seq=32,768   global_batch=32    prefill_step
    decode_32k    seq=32,768   global_batch=128   serve_step (1 new token)
    long_500k     seq=524,288  global_batch=1     serve_step (1 new token)

``long_500k`` policy: SSM / hybrid / linear-attention archs run natively
(O(1) state or native window); full-attention archs run a sliding-window
variant (window 8192) per the assignment carve-in.

The stand-ins are meta tensors (shapes and dtypes, no storage; the
parameters are drawn under ``FakeTensorMode`` and laid on the meta
device); where a mesh is given they are DTensors with the partition
rules' placements, whose local shards are rank 0's. Nothing is
allocated. (Meta, not fake: DTensor computes the offsets of a strided
shard with index tensors that it reads back, which a fake tensor cannot
give.)
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import init_decode_cache, init_params
from ..models.config import ModelConfig
from ..sharding.partition import (P, ShardingOptions, cache_placements,
                                  distribute, mesh_shape, param_specs,
                                  placements, token_spec, tree_map2)
from ..train.optimizer import OptState, init_opt_state

LONG_CONTEXT_WINDOW = 8192


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}


def adapt_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Shape-specific config adaptation: long_500k on a full-attention
    arch -> sliding-window variant."""
    if shape.name == "long_500k" and cfg.sliding_window is None \
            and cfg.backbone_kind in ("attn", "moe") and not cfg.has_shared_attn:
        cfg = dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def _on_meta(build):
    """``build()``'s tree with every tensor on the meta device; ``build``
    runs under ``FakeTensorMode``, so its random draws allocate nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = build()
    return tree_map2(lambda t, _: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), tree, tree)


def _tokens(mesh, batch: int, shape: tuple, dtype):
    t = torch.empty(shape, dtype=dtype, device="meta")
    if mesh is None:
        return t
    return distribute(t, placements(token_spec(mesh, batch), mesh), mesh)


def params_specs_for(cfg: ModelConfig, mesh,
                     opts: ShardingOptions = ShardingOptions()):
    """(parameter stand-ins, their placements; None without a mesh)."""
    params = _on_meta(lambda: init_params(cfg, 0, "cpu"))
    if mesh is None:
        return params, None
    specs = param_specs(cfg, params, mesh, opts)
    pls = tree_map2(lambda _, s: placements(s, mesh), params, specs)
    return distribute(params, pls, mesh), pls


def input_specs(cfg: ModelConfig, shape: InputShape, mesh,
                opts: ShardingOptions = ShardingOptions()) -> dict:
    """Stand-ins (DTensors where a mesh is given) for every model input of
    the given step kind, keyed by the step function's signature, with the
    adapted config under ``cfg`` and, for decode, the cache's placements
    under ``cache_placements``."""
    cfg = adapt_config(cfg, shape)
    out: dict = {"cfg": cfg}
    prefix = None
    if cfg.n_prefix_embeds and shape.kind != "decode":
        prefix = _tokens(mesh, shape.batch,
                         (shape.batch, cfg.n_prefix_embeds, cfg.d_model),
                         cfg.tdtype)
    if shape.kind == "train":
        text = shape.seq - cfg.n_prefix_embeds
        batch = {"tokens": _tokens(mesh, shape.batch,
                                   (shape.batch, text + 1), torch.int32)}
        if prefix is not None:
            batch["prefix_embeds"] = prefix
        out["batch"] = batch
    elif shape.kind == "prefill":
        text = shape.seq - cfg.n_prefix_embeds
        out["tokens"] = _tokens(mesh, shape.batch, (shape.batch, text),
                                torch.int32)
        if prefix is not None:
            out["prefix_embeds"] = prefix
    else:  # decode
        out["token"] = _tokens(mesh, shape.batch, (shape.batch, 1),
                               torch.int32)
        cache = _on_meta(lambda: init_decode_cache(cfg, shape.batch,
                                                   shape.seq, "cpu"))
        pls = None if mesh is None else cache_placements(
            cfg, cache, mesh, shape.batch, opts)
        out["cache"] = cache if mesh is None else distribute(cache, pls,
                                                             mesh)
        out["cache_placements"] = pls
    return out


def _zero_spec(spec: P, shape: tuple, mesh) -> P:
    """ZeRO: the first unsplit dimension that ``data`` divides goes on
    ``data``."""
    spec = list(spec) + [None] * (len(shape) - len(spec))
    dsize = mesh_shape(mesh)["data"]
    for i, (s, dim) in enumerate(zip(spec, shape)):
        if s is None and dim % dsize == 0:
            spec[i] = "data"
            break
    return P(*spec)


def train_state_specs(cfg: ModelConfig, mesh,
                      opts: ShardingOptions = ShardingOptions()):
    """(TrainState stand-ins, TrainState placements): the parameters
    placed by the rules, the AdamW moments alike or, with
    ``zero_optimizer``, each also split over ``data`` on its first free
    dimension that divides (ZeRO), the step replicated."""
    from ..train.trainer import TrainState
    params = _on_meta(lambda: init_params(cfg, 0, "cpu"))
    opt = init_opt_state(params)
    if mesh is None:
        return TrainState(params=params, opt=opt), None
    specs = param_specs(cfg, params, mesh, opts)
    p_pl = tree_map2(lambda _, s: placements(s, mesh), params, specs)
    if opts.zero_optimizer:
        m_pl = tree_map2(
            lambda t, s: placements(_zero_spec(s, tuple(t.shape), mesh),
                                    mesh), params, specs)
    else:
        m_pl = p_pl
    step_pl = placements(P(), mesh)
    pls = TrainState(params=p_pl,
                     opt=OptState(m=m_pl, v=m_pl, step=step_pl))
    state = TrainState(
        params=distribute(params, p_pl, mesh),
        opt=OptState(m=distribute(opt.m, m_pl, mesh),
                     v=distribute(opt.v, m_pl, mesh),
                     step=distribute(opt.step, step_pl, mesh)))
    return state, pls
