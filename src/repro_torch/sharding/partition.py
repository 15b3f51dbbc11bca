"""Partition rules: parameters, activations and caches -> partition specs
(``repro.sharding.partition``).

Baseline scheme (megatron-style tensor parallel over ``model`` + data
parallel over ``data`` [+ ``pod``]):

* attention:  wq/wk/wv column-parallel (heads on ``model``), wo row-parallel
* MLP:        up/gate column-parallel, down row-parallel
* MoE:        per-expert FFN hidden dim on ``model`` (works for any expert
              count, incl. granite's 40); expert-parallel variant
              (experts on ``model``) is the `expert_parallel` option
* Mamba2:     z/x projections head-column-parallel, out row-parallel;
              B/C/dt projections replicated (small)
* RWKV6:      wr/wk/wv/wg column-parallel, wo row-parallel
* embeddings: vocab-parallel (both token table and LM head)
* KV caches:  kv-head-parallel when divisible, else head-dim-parallel,
              else replicated; batch on ``data`` (+ ``pod``)

The rules are the JAX package's, keyed by the same tree paths: the port's
parameter and cache trees have its keys, with a leading layer axis on
``blocks`` (two on the hybrid's ``grouped`` caches). A spec is :class:`P`,
a tuple with one entry a tensor dimension (a mesh axis name, a tuple of
names sharded major first, or None), so it compares equal to the JAX
package's ``PartitionSpec`` as a tuple. :func:`placements` turns it into
DTensor placements (``Shard(d)`` / ``Replicate()`` a mesh dimension).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or anything with
a ``shape`` mapping of axis sizes and ``axis_names`` (the tests' stand-in
for the production meshes). Where the port's tree differs from the JAX
package's, the spec follows the port's leaf: its KV caches' ``length`` is
one 0-d tensor for every layer (the JAX package stacks one a layer), so
its spec is ``P()``; the recurrent caches' ``length`` is a host int and
gets none.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Any, Callable

import torch

if TYPE_CHECKING:   # models/moe.py imports this module
    from ..models.config import ModelConfig

Tensor = torch.Tensor


class P(tuple):
    """A partition spec: per tensor dimension, a mesh axis name, a tuple
    of names (the dimension split over their product, the first major),
    or None (not split). Missing trailing entries mean None. A tuple of
    one name is that name, as the JAX package's ``PartitionSpec`` has it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


@dataclasses.dataclass(frozen=True)
class ShardingOptions:
    expert_parallel: bool = False     # experts over `model` (hillclimb)
    seq_sharded_cache: bool = False   # long-context KV cache over `data`
    zero_optimizer: bool = False      # shard opt state over `data` (ZeRO)


def mesh_shape(mesh) -> dict:
    """Axis name -> size of a ``DeviceMesh`` or a stand-in mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _msize(mesh) -> int:
    return mesh_shape(mesh)["model"]


def batch_split(mesh, batch_size: int):
    """The batch axes a batch of ``batch_size`` rows is split over, or None
    where their product does not divide it (the batch is replicated)."""
    shape = mesh_shape(mesh)
    ba = batch_axes(mesh)
    return ba if batch_size % math.prod(shape[a] for a in ba) == 0 else None


# ------------------------------------------------------------- tree paths
def tree_map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` on every tensor leaf of a tree of dicts and
    NamedTuples, in its structure; ``path`` holds the dict keys and field
    names down to the leaf. Other leaves (None, host ints) map to None."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if isinstance(tree, Tensor):
        return fn(path, tree)
    return None


def tree_map2(fn: Callable, tree: Any, other: Any) -> Any:
    """``fn(leaf, other_leaf)`` over the tensor leaves of ``tree`` and the
    matching leaves of ``other`` (a tree of the same structure whose
    leaves may be any object, specs or placements)."""
    if isinstance(tree, dict):
        return {k: tree_map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map2(fn, v, o)
                            for v, o in zip(tree, other)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map2(fn, v, o) for v, o in zip(tree, other))
    if isinstance(tree, Tensor):
        return fn(tree, other)
    return tree


# --------------------------------------------------------------- param rules
def _param_spec(cfg: ModelConfig, keys: tuple, shape: tuple,
                opts: ShardingOptions, mesh) -> P:
    name = keys[-1]
    parent = keys[-2] if len(keys) > 1 else None
    ms = _msize(mesh)
    ndim = len(shape)

    def col(dim_size):  # column-parallel last dim if divisible
        return P(None, "model") if dim_size % ms == 0 else P(None, None)

    # embeddings: vocab-parallel, falling back to d-parallel for vocab
    # sizes that don't divide the model axis (granite's 49155)
    if name == "tok":
        return P("model", None) if shape[0] % ms == 0 else P(None, "model")
    if name == "head":
        return P(None, "model") if shape[1] % ms == 0 else P("model", None)

    # attention
    if parent == "attn":
        if name in ("wq", "wk", "wv"):
            return col(shape[-1])
        if name == "wo":
            return P("model", None) if shape[-2] % ms == 0 \
                else P(None, None)
        return P(None)                   # q_norm / k_norm [hd]
    # dense MLP
    if parent == "mlp":
        if name in ("up", "gate"):
            return col(shape[-1])
        if name == "down":
            return P("model", None)
    # MoE
    if parent == "moe" or name in ("w_gate", "w_up", "w_down", "router"):
        if name == "router":
            return P(None, None)
        if opts.expert_parallel and shape[0] % ms == 0:
            return P("model", None, None)       # experts on model
        if name in ("w_gate", "w_up"):
            return P(None, None, "model") if shape[-1] % ms == 0 \
                else P(None, None, None)
        if name == "w_down":
            return P(None, "model", None) if shape[-2] % ms == 0 \
                else P(None, None, None)
    if parent == "shared":               # MoE shared experts = dense MLP
        if name in ("gate", "up"):
            return col(shape[-1])
        if name == "down":
            return P("model", None)
    # Mamba2
    if parent == "mamba":
        if name in ("z_proj", "x_proj"):
            return col(shape[-1])
        if name == "out_proj":
            return P("model", None) if shape[-2] % ms == 0 \
                else P(None, None)
        if name in ("conv_x", "conv_b_x", "norm"):
            if ndim == 2 and shape[-1] % ms == 0:
                return P(None, "model")
            return P("model") if ndim == 1 and shape[0] % ms == 0 \
                else P(None)
        if name in ("A_log", "D", "dt_bias"):
            return P("model") if shape[0] % ms == 0 else P(None)
        return P(None) if ndim == 1 else P(*(None,) * ndim)
    # RWKV6
    if parent == "rwkv":
        if name in ("wr", "wk", "wv", "wg"):
            return col(shape[-1])
        if name == "wo":
            return P("model", None)
        if name == "wB":
            return col(shape[-1])
        if name == "u":
            return P("model", None) if shape[0] % ms == 0 else P(None, None)
        if name == "ln_x":
            return P("model") if shape[0] % ms == 0 else P(None)
        if name == "ck":
            return col(shape[-1])
        if name == "cv":
            return P("model", None)
        return P(*(None,) * ndim)
    # norms and everything else: replicated
    return P(*(None,) * ndim)


def _divisible(spec: P, shape: tuple, mesh) -> P:
    """The final divisibility guard: drop any axis that does not divide
    its dimension. DTensor takes uneven shards where GSPMD's specs would
    not, so without it the layouts would drift from the JAX package's."""
    sizes = mesh_shape(mesh)
    fixed = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        if ax is None:
            fixed.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n = math.prod(sizes[a] for a in axes)
        fixed.append(ax if dim % n == 0 else None)
    return P(*fixed)


def param_specs(cfg: ModelConfig, params_shape: Any, mesh,
                opts: ShardingOptions = ShardingOptions()) -> Any:
    """Map a parameter tree (of tensors, fake or real) to :class:`P`.

    Stacked block params have a leading layer axis: the rule is computed on
    the per-layer shape and the layer axis is left unsharded.
    """
    def spec_for(keys, leaf):
        stacked = "blocks" in keys
        shape = tuple(leaf.shape)
        spec = _param_spec(cfg, keys, shape[1:] if stacked else shape,
                           opts, mesh)
        if stacked:
            spec = P(None, *spec)
        return _divisible(spec, shape, mesh)

    return tree_map_with_path(spec_for, params_shape)


# ---------------------------------------------------------------- data rules
def token_spec(mesh, batch_size: int) -> P:
    # tiny batches (long_500k): replicate
    return P(batch_split(mesh, batch_size), None)


def cache_spec(cfg: ModelConfig, mesh, batch_size: int,
               opts: ShardingOptions = ShardingOptions()) -> Callable:
    """Spec factory for KV / state caches (per leaf, layer-stacked).

    Returns a function ``(path, leaf) -> P`` for :func:`tree_map_with_path`
    over the cache tree of ``init_decode_cache`` (leaves have a leading
    layer axis).
    """
    ms = _msize(mesh)
    bspec = batch_split(mesh, batch_size)

    def leaf_spec(keys, leaf):
        keys = tuple(str(k) for k in keys)
        # grouped hybrid caches carry two leading stack axes
        lead = 2 if "grouped" in keys else 1
        shape = tuple(leaf.shape[lead:])
        field = keys[-1] if keys else ""
        pre = (None,) * lead
        seq = "data" if (opts.seq_sharded_cache and bspec is None) else None
        if field in ("k", "v"):            # [B, C, nkv, hd]
            b, c, nkv, hd = shape
            if nkv % ms == 0:
                return P(*pre, bspec, seq, "model", None)
            if hd % ms == 0:
                return P(*pre, bspec, seq, None, "model")
            return P(*pre, bspec, seq, None, None)
        if field in ("k_scale", "v_scale"):   # [B, C, nkv] (int8 cache)
            b, c, nkv = shape
            return P(*pre, bspec, seq, "model" if nkv % ms == 0 else None)
        if field == "ssd":                 # [B, nh, hd, ds]
            b, nh, hd, ds = shape
            return P(*pre, bspec, "model" if nh % ms == 0 else None,
                     None, None)
        if field == "wkv":                 # [B, nh, hd, hd]
            b, nh, hd, _ = shape
            return P(*pre, bspec, "model" if nh % ms == 0 else None,
                     None, None)
        if field == "conv_x":              # [B, K-1, d_in]
            return P(*pre, bspec, None,
                     "model" if shape[-1] % ms == 0 else None)
        if field in ("shift_tm", "shift_cm"):
            return P(*pre, bspec, None)
        if field == "conv_bc":
            return P(*pre, bspec, None, None)
        if field == "length":              # the port's: one 0-d position
            return P(*pre[:leaf.dim()])
        return P(*(None,) * leaf.dim())

    return leaf_spec


# ------------------------------------------------------------- placements
def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension that splits tensor dimension ``d``, ``Replicate()`` on
    the others. A dimension split over several axes is split over them in
    mesh order, which is the JAX package's major-first order for
    ``("pod", "data")``."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(ax)] = Shard(dim)
    return tuple(out)


def param_placements(cfg: ModelConfig, params_shape: Any, mesh,
                     opts: ShardingOptions = ShardingOptions()) -> Any:
    """The counterpart of ``param_shardings``: a tree of placements."""
    specs = param_specs(cfg, params_shape, mesh, opts)
    return tree_map2(lambda _, s: placements(s, mesh), params_shape, specs)


def cache_placements(cfg: ModelConfig, cache_shape: Any, mesh,
                     batch_size: int,
                     opts: ShardingOptions = ShardingOptions()) -> Any:
    """The counterpart of ``cache_shardings``: a tree of placements."""
    fn = cache_spec(cfg, mesh, batch_size, opts)
    return tree_map_with_path(lambda p, leaf: placements(fn(p, leaf), mesh),
                              cache_shape)


def distribute(tree: Any, placements_tree: Any, mesh) -> Any:
    """Each tensor leaf as a DTensor on ``mesh`` with its placements. Every
    rank holds the whole leaf (the same seed, or a shape-only fake) and
    keeps its own shard; nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    return tree_map2(
        lambda t, pl: distribute_tensor(t, mesh, list(pl), src_data_rank=None),
        tree, placements_tree)
