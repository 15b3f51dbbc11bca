"""Fine-grained Mixture-of-Experts (DeepSeek-MoE / Granite style).

The port of ``repro.models.moe``: its single-device path (``_moe_local``)
and, when a mesh is installed (``sharding.context``), its two sharded
dispatches (``_moe_shardmap``, ``_moe_shardmap_ep``). Shared
experts always run; routed experts take top-k token choice. The three
dispatches of the JAX package:

* ``capacity`` (the configs' default): each expert's (token, slot) pairs
  fill a fixed ``[E, C, d]`` buffer, ``C = max(1, int(T k cf / E))``, in
  the order of their flat index ``t k + j`` (the JAX package's stable
  argsort), so an expert's later pairs are dropped past row C. One
  ``fused_ffn`` launch runs every expert over the buffer with
  ``rows = min(group size, C)``: the kernel skips the rows no pair
  landed in, and the experts no pair went to.
* ``ragged``: dropless. The JAX package sorts the pairs by expert and runs
  ``jax.lax.ragged_dot``. On the card the port fills the same buffer at
  ``C = T``: a token's top-k experts are distinct, so no expert gets more
  than T pairs and none is dropped, and ``rows = group sizes`` makes the
  work and the weight bytes follow the experts the batch hit, as
  ``ragged_dot``'s do, with static shapes and no host read (the decode
  step is captured as a CUDA graph). On the CPU and under ``force_ref`` it
  runs the JAX package's sorted-rows math (``ref.grouped_ffn_ref``).
* ``dense``: every expert on every token, gated combine; the oracle.

Decode (S == 1) is dropless: ``capacity`` turns into ``ragged`` there, as
in the JAX package (so a one-token prompt's prefill is ragged too).

The (token, slot) ranks, the group sizes and each pair's buffer rows come
from one launch of the ``moe_ranks`` kernel (``kernels/moe_ranks.py``),
which counts each expert's pairs in flat order, without a sort and with
no host read (``bincount`` on the card would read its maximum back to the
host); on the CPU and under ``force_ref`` from its plain version, a
cumulative count of a one-hot over the experts. The outputs are
combined without atomics: each pair's output is gathered back to
``[T, k, d]`` and summed over k in slot order, so two runs of a step (the
eager one and its replayed graph) give the same bits. ``moe_forward``
adds the switch-style load-balance loss ``E * sum_e f_e P_e * coef`` of
the routing; the decode step calls ``moe_apply``, which leaves it out.

Entry points: ``moe_forward(cfg, p, x, force_ref=False) -> (y, aux)``,
``moe_apply(cfg, p, x, force_ref=False) -> (y, probs, experts)``.

Routing counts (``count_routing``): a traced serving engine installs a
:class:`RoutingCounts` around its prefill and its captured decode step;
while it is installed, each layer that computes its group sizes (the
buffer dispatch, and the CPU's sorted-rows dispatch) copies them into
the recorder's static ``[L, steps, E]`` buffer, one device op a layer, at
a device-side step index, so a captured step records them on every
replay. Nothing is installed otherwise, and the layers add no op.

Under a mesh ``moe_forward`` takes DTensors and runs the JAX package's
``shard_map`` bodies on the local shards through ``local_map``, on the
reference math only (the sharded path takes no kernel):

* ``_moe_shardmap``: each data shard routes its own tokens (a global sort
  would gather every shard's activations); the experts' hidden dimension
  is split over ``model``, so each rank's down-projection is a partial
  sum, handed back as a ``Partial`` DTensor that the next op reduces over
  ``model`` (the JAX package's ``psum``), and the aux loss of each data
  shard comes back as one entry of a vector sharded over the batch axes,
  whose mean is the JAX package's ``pmean``.
* ``_moe_shardmap_ep``: the GShard pattern. Experts are split over
  ``model``; each model rank routes a contiguous token slice, packs a
  ``[msize, C, d]`` send buffer by destination rank, exchanges it with
  ``all_to_all`` both ways around its local experts' capacity dispatch,
  and hands its slice back sharded over ``model`` on the token axis,
  where DTensor's all-gather rebuilds the tokens (the JAX package's
  ``all_gather``; its gradient is a slice, not a reduce-scatter).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from ..kernels import ops as kops
from ..kernels import ref
from ..sharding import context
from ..sharding.partition import P, batch_split, mesh_shape, placements
from .config import ModelConfig
from .layers import _he

Tensor = torch.Tensor


def init_moe(cfg: ModelConfig, gen: torch.Generator, lead: tuple) -> dict:
    """``router [d, E]``, the routed experts stacked for one launch
    (``w_gate`` / ``w_up [E, d, f]``, ``w_down [E, f, d]``) and, with
    shared experts, ``shared: {gate, up, down}`` of width ``f * n_shared``;
    every leaf stacked on ``lead``. Scales are the JAX package's ``_he``,
    whose fan-in defaults to the leaf's first axis: d for the router and
    the shared gate and up, E for the routed experts, ``f * n_shared``
    for the shared down."""
    m = cfg.moe
    d, E, f, dt = cfg.d_model, m.n_experts, m.d_expert, cfg.tdtype
    p = {"router": _he(gen, lead + (d, E), dt, fan_in=d),
         "w_gate": _he_sliced(gen, lead + (E, d, f), dt, fan_in=E),
         "w_up": _he_sliced(gen, lead + (E, d, f), dt, fan_in=E),
         "w_down": _he_sliced(gen, lead + (E, f, d), dt, fan_in=E)}
    if m.n_shared_experts:
        dsh = f * m.n_shared_experts
        p["shared"] = {"gate": _he(gen, lead + (d, dsh), dt, fan_in=d),
                       "up": _he(gen, lead + (d, dsh), dt, fan_in=d),
                       "down": _he(gen, lead + (dsh, d), dt, fan_in=dsh)}
    return p


def _he_sliced(gen: torch.Generator, shape: tuple, dtype,
               fan_in: int) -> Tensor:
    """``_he`` drawn one slice of the leading axis at a time: a routed
    expert leaf of deepseek-moe-16b is 10 GB in bf16, and its f32 draw
    whole would need twice that again, twice over."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for i in range(shape[0]):
        out[i] = _he(gen, shape[1:], dtype, fan_in)
    return out


def _route(cfg: ModelConfig, p: dict, x2d: Tensor):
    """x2d [T, d] -> (weights [T, k] in x's dtype, experts [T, k] int64,
    router probabilities [T, E] f32): softmax in f32 over the router's
    logits, top-k, the k weights renormalised."""
    probs = torch.softmax(torch.matmul(x2d, p["router"]).float(), dim=-1)
    w, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w.to(x2d.dtype), idx, probs


def _aux_loss(cfg: ModelConfig, probs: Tensor, idx: Tensor) -> Tensor:
    """The switch-style load-balance loss ``E * sum_e f_e P_e * coef``:
    f_e the pairs routed to expert e over T (counted by a scatter, with no
    one-hot), P_e its mean router probability."""
    m = cfg.moe
    f = torch.zeros(m.n_experts, dtype=torch.float32, device=idx.device) \
        .scatter_add_(0, idx.reshape(-1),
                      torch.ones(idx.numel(), device=idx.device)) \
        / idx.shape[0]
    return m.n_experts * torch.sum(f * probs.mean(0)) * m.router_aux_coef


def _expert_ranks(n_experts: int, idx: Tensor) -> tuple:
    """For the pairs in flat order ``t k + j``: (expert [T k], rank among
    that expert's pairs [T k], pairs per expert [E] int32), with no host
    read: the ranks' plain version, as its one caller runs only on the CPU
    or under ``force_ref``."""
    pos, sizes, _, _ = kops.moe_ranks_plain(idx, n_experts)
    return idx.reshape(-1), pos, sizes


class RoutingCounts:
    """Pairs per expert of each MoE layer of a forward or a decode step:
    ``counts [L, steps, E]`` int32 on the device, the layers' group sizes
    at row ``step`` (a 0-d device index, advanced by the caller between
    steps; None: row 0). Allocated once and written in place."""

    def __init__(self, n_layers: int, n_experts: int, device,
                 steps: int = 1, step: Optional[Tensor] = None):
        self.counts = torch.zeros((n_layers, steps, n_experts),
                                  dtype=torch.int32, device=device)
        self.step = step
        self.layer = 0

    def note(self, group_sizes: Tensor) -> None:
        row = self.counts[self.layer]
        if self.step is None:
            row[0].copy_(group_sizes)
        else:
            row.index_copy_(0, self.step.reshape(1), group_sizes[None])
        self.layer += 1


_ROUTING: list = []


@contextlib.contextmanager
def count_routing(recorder: Optional[RoutingCounts]):
    """Install ``recorder`` for the MoE layers run inside (its layer
    count from 0); None installs nothing."""
    if recorder is None:
        yield
        return
    recorder.layer = 0
    _ROUTING.append(recorder)
    try:
        yield
    finally:
        _ROUTING.pop()


def _note_routing(group_sizes: Tensor) -> None:
    if _ROUTING:
        _ROUTING[-1].note(group_sizes)


def _moe_dense(cfg: ModelConfig, p: dict, x2d: Tensor, w: Tensor,
               idx: Tensor) -> Tensor:
    """Every expert on every token, combined with the top-k gates."""
    m = cfg.moe
    gates = torch.zeros(x2d.shape[0], m.n_experts, dtype=x2d.dtype,
                        device=x2d.device).scatter(1, idx, w)
    h = torch.nn.functional.silu(
        torch.einsum("td,edf->etf", x2d, p["w_gate"]).float()).to(x2d.dtype)
    h = h * torch.einsum("td,edf->etf", x2d, p["w_up"])
    y = torch.einsum("etf,efd->etd", h, p["w_down"])
    return torch.einsum("etd,te->td", y, gates)


def _moe_buffered(cfg: ModelConfig, p: dict, x2d: Tensor, w: Tensor,
                  idx: Tensor, C: int, force_ref: bool = False) -> Tensor:
    """The ``[E, C, d]`` buffer dispatch: pair (t, j) goes to row ``rank``
    of its expert's block and is dropped at ``rank >= C``; one
    ``fused_ffn`` over the buffer with ``rows = min(group size, C)``; each
    kept output gathered back to its pair, weighted, and summed over k."""
    T, k = idx.shape
    d, E = x2d.shape[-1], cfg.moe.n_experts
    # a dropped pair writes to a spare row past the buffer and reads pair
    # 0's row (rank 0 < C: always kept), so no unwritten row is read
    _, group_sizes, rows_in, rows_out = kops.moe_ranks(
        idx, E, C, force_ref=force_ref)
    _note_routing(group_sizes)
    buf = x2d.new_zeros(E * C + 1, d)
    buf.index_copy_(0, rows_in, x2d[:, None].expand(T, k, d).reshape(T * k, d))
    y = kops.fused_ffn(buf[:E * C].view(E, C, d), p["w_gate"], p["w_up"],
                       p["w_down"], rows=group_sizes.clamp(max=C),
                       force_ref=force_ref)
    y = y.reshape(E * C, d).index_select(0, rows_out)
    wk = torch.where(rows_in < E * C, w.reshape(-1), 0)
    return (y * wk[:, None]).view(T, k, d).sum(1)


def capacity(cfg: ModelConfig, T: int) -> int:
    """The capacity dispatch's rows an expert over ``T`` tokens:
    ``C = max(1, int(T k cf / E))``, from static shapes."""
    m = cfg.moe
    return max(1, int(T * m.top_k * m.capacity_factor / m.n_experts))


def _moe_capacity(cfg: ModelConfig, p: dict, x2d: Tensor, w: Tensor,
                  idx: Tensor, force_ref: bool = False) -> Tensor:
    """GShard/Switch-style capacity dispatch, dropping each expert's pairs
    past ``capacity(cfg, T)``."""
    C = capacity(cfg, idx.shape[0])
    return _moe_buffered(cfg, p, x2d, w, idx, C, force_ref=force_ref)


def _moe_ragged(cfg: ModelConfig, p: dict, x2d: Tensor, w: Tensor,
                idx: Tensor, force_ref: bool = False) -> Tensor:
    """Dropless dispatch: on the card the buffer at ``C = T`` (exact: no
    expert gets more than T pairs); on the CPU and under ``force_ref`` the
    JAX package's pairs sorted by expert through ``grouped_ffn_ref``.

    The card's buffer is sized for decode-size T (the batch): it holds
    ``E * T`` rows, and the kernel's hidden ``E * T * f``, whatever the
    routing. The shipped configs dispatch by capacity and reach this only
    at S == 1; ``impl="ragged"`` at a long prompt (T in the thousands)
    would allocate E times the prompt's rows a layer."""
    T, k = idx.shape
    if not force_ref and x2d.device.type != "cpu":
        return _moe_buffered(cfg, p, x2d, w, idx, T)
    flat_e, _, group_sizes = _expert_ranks(cfg.moe.n_experts, idx)
    _note_routing(group_sizes)
    order = torch.argsort(flat_e, stable=True)
    y = ref.grouped_ffn_ref(x2d[order // k], p["w_gate"], p["w_up"],
                            p["w_down"], group_sizes)
    y = y * w.reshape(-1)[order][:, None]
    # back to flat pair order through the inverse permutation, then sum
    # over k (no scatter-add)
    return y[torch.argsort(order)].view(T, k, -1).sum(1)


def _dispatch(cfg: ModelConfig, p: dict, x2d: Tensor, w: Tensor,
              idx: Tensor, decode: bool = False,
              force_ref: bool = False) -> Tensor:
    impl = cfg.moe.impl
    if impl == "capacity" and decode:
        # decode steps must be dropless (a dropped token is a corrupted
        # response)
        impl = "ragged"
    if impl == "capacity":
        return _moe_capacity(cfg, p, x2d, w, idx, force_ref=force_ref)
    if impl == "ragged":
        return _moe_ragged(cfg, p, x2d, w, idx, force_ref=force_ref)
    return _moe_dense(cfg, p, x2d, w, idx)


def _shared_experts(p: dict, x2d: Tensor, force_ref: bool) -> Tensor:
    """The always-on experts, one SwiGLU of width ``f * n_shared``: the
    fused FFN kernel at E = 1, as the dense MLP; ``force_ref`` the JAX
    package's einsum chain."""
    if force_ref:
        g = torch.nn.functional.silu(
            torch.matmul(x2d, p["gate"]).float()).to(x2d.dtype)
        return torch.matmul(g * torch.matmul(x2d, p["up"]), p["down"])
    return kops.fused_ffn(x2d[None], p["gate"][None], p["up"][None],
                          p["down"][None])[0]


def moe_apply(cfg: ModelConfig, p: dict, x: Tensor,
              force_ref: bool = False):
    """x [B, S, d] -> (y [B, S, d], router probabilities [B S, E] f32,
    experts [B S, k]): route, dispatch, combine, add the shared experts
    (the JAX package's ``_moe_local``, which its ``moe_forward`` runs when
    no mesh is installed), with no aux loss: the decode step calls this.
    ``force_ref`` runs the JAX package's math in place of the kernels."""
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    w, idx, probs = _route(cfg, p, x2d)
    y = _dispatch(cfg, p, x2d, w, idx, decode=(S == 1), force_ref=force_ref)
    if cfg.moe.n_shared_experts:
        y = y + _shared_experts(p["shared"], x2d, force_ref)
    return y.reshape(B, S, d), probs, idx


def moe_forward(cfg: ModelConfig, p: dict, x: Tensor,
                force_ref: bool = False):
    """x [B, S, d] -> (y [B, S, d], aux loss f32 scalar): ``moe_apply``
    and the load-balance loss of its routing; under a mesh, the sharded
    dispatches (the expert-parallel one with ``expert_parallel`` when the
    experts and the tokens divide over ``model``)."""
    mesh = context.get_mesh()
    if mesh is None:
        y, probs, idx = moe_apply(cfg, p, x, force_ref=force_ref)
        return y, _aux_loss(cfg, probs, idx)
    if not force_ref:
        raise ValueError("the sharded MoE runs the reference math: pass "
                         "force_ref=True under a mesh")
    opts = context.get_options()
    ep = bool(getattr(opts, "expert_parallel", False))
    msize = mesh_shape(mesh).get("model", 1)
    tokens = x.shape[0] * x.shape[1]
    if (ep and msize > 1 and cfg.moe.n_experts % msize == 0
            and tokens % msize == 0):
        return _moe_shardmap_ep(cfg, p, x, mesh)
    return _moe_shardmap(cfg, p, x, mesh)


def _local_map(mesh, fn, args: tuple, in_specs: tuple, out_placements,
               bspec):
    """``fn`` on the local shards of ``args`` (DTensors, laid out as
    ``in_specs`` first: a tree of :class:`P` per argument), its outputs
    wrapped back as DTensors with ``out_placements``.

    Gradients: an input replicated over an axis whose ranks split the work
    (the batch axes when the tokens are split, ``bspec``; and ``model``,
    where ``fn`` splits the experts, the hidden dimension or the tokens,
    and lets rank 0 alone hand back what every rank computed whole) gets
    a ``Partial`` gradient there, each rank's contribution; where the work
    is duplicated (the batch axes of a replicated batch) a replicated one.
    """
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    from torch.utils import _pytree as pytree

    def ordered(arg, spec):   # the specs in the argument's key order
        if isinstance(arg, dict):
            return {k: ordered(v, spec[k]) for k, v in arg.items()}
        return spec
    in_specs = tuple(ordered(a, s) for a, s in zip(args, in_specs))
    flat = pytree.tree_leaves(in_specs, is_leaf=lambda s: isinstance(s, P))
    in_pl = tuple(placements(s, mesh) for s in flat)
    split = ("model",) + (tuple(bspec) if bspec is not None else ())

    def grad_pl(pl):
        return tuple(p if not isinstance(p, Replicate)
                     else (Partial() if ax in split else p)
                     for p, ax in zip(pl, mesh.mesh_dim_names))
    return local_map(fn, out_placements=out_placements, in_placements=in_pl,
                     in_grad_placements=tuple(grad_pl(p) for p in in_pl),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _out_placements(mesh, bspec, model) -> tuple:
    """Placements of an output sharded on dim 0 over the batch axes (when
    ``bspec``) and placed ``model`` on the model axis."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(model if ax == "model"
                 else (Shard(0) if bspec is not None else Replicate())
                 for ax in mesh.mesh_dim_names)


def _moe_shardmap(cfg: ModelConfig, p: dict, x: Tensor, mesh):
    """Per-data-shard routing with hidden-sharded experts (the JAX
    package's ``_moe_shardmap``)."""
    from torch.distributed.tensor import Partial
    msize = mesh_shape(mesh).get("model", 1)
    m = cfg.moe
    fe_sharded = msize > 1 and m.d_expert % msize == 0
    dsh = m.d_expert * m.n_shared_experts
    sh_sharded = bool(msize > 1 and m.n_shared_experts and dsh % msize == 0)
    bspec = batch_split(mesh, x.shape[0])
    x_spec = P(bspec, None, None)
    col = P(None, None, "model") if fe_sharded else P(None, None, None)
    p_specs = {"router": P(None, None), "w_gate": col, "w_up": col,
               "w_down": (P(None, "model", None) if fe_sharded
                          else P(None, None, None))}
    if "shared" in p:
        p_specs["shared"] = {
            "gate": P(None, "model") if sh_sharded else P(None, None),
            "up": P(None, "model") if sh_sharded else P(None, None),
            "down": P("model", None) if sh_sharded else P(None, None)}
    p_in = {k: p[k] for k in p_specs}
    first = mesh.get_local_rank("model") == 0

    def whole(t):   # computed whole on every model rank: rank 0's counts
        return t if first else torch.zeros_like(t)

    def local_fn(p_local, x_local):
        B, S, d = x_local.shape
        x2d = x_local.reshape(B * S, d)
        w, idx, probs = _route(cfg, p_local, x2d)
        y = _dispatch(cfg, p_local, x2d, w, idx, decode=(S == 1),
                      force_ref=True).reshape(B, S, d)
        out = [y if fe_sharded else whole(y)]
        if m.n_shared_experts:
            ys = _shared_experts(p_local["shared"], x2d, True) \
                .reshape(B, S, d)
            out.append(ys if sh_sharded else whole(ys))
        return (*out, whole(_aux_loss(cfg, probs, idx)[None]))

    # every output is a sum over model: of partial down-projections (the
    # psum over model), or of rank 0's whole value and zeros
    sums = _out_placements(mesh, bspec, Partial())
    outs = _local_map(mesh, local_fn, (p_in, x), (p_specs, x_spec),
                      (sums,) * (3 if "shared" in p else 2), bspec)
    y, ys, aux = outs if "shared" in p else (outs[0], None, outs[1])
    if ys is not None:
        y = y + ys
    # every data shard routed a disjoint token slice: the mean of their
    # aux losses (the pmean over the batch axes)
    return y, aux.mean()


def _count(idx: Tensor, n: int) -> Tensor:
    """``bincount(idx, minlength=n)`` for ``idx < n``, with a static shape
    (a scatter: the dry-run's meta tensors have no ``bincount``)."""
    return torch.zeros(n, dtype=torch.long, device=idx.device) \
        .scatter_add_(0, idx, torch.ones_like(idx))


def _moe_shardmap_ep(cfg: ModelConfig, p: dict, x: Tensor, mesh):
    """Expert-parallel MoE: experts sharded over ``model``, tokens
    exchanged with all-to-all (the JAX package's ``_moe_shardmap_ep``).

    Each model rank takes a contiguous slice of the (data-)local tokens,
    routes it, packs a fixed-capacity [msize, C, d] send buffer keyed by
    the destination rank (= expert // E_loc), all-to-alls it, runs the
    local experts with capacity dispatch, all-to-alls the outputs back,
    and combines its slice; DTensor then all-gathers the slices. Shared
    experts stay replicated.
    """
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    group = mesh.get_group("model")
    msize = mesh_shape(mesh)["model"]
    rank = mesh.get_local_rank("model")
    m = cfg.moe
    e_loc = m.n_experts // msize
    B, S, d = x.shape
    bspec = batch_split(mesh, B)
    x_spec = P(bspec, None, None)
    p_specs = {"router": P(None, None), "w_gate": P("model", None, None),
               "w_up": P("model", None, None),
               "w_down": P("model", None, None)}
    if "shared" in p:
        p_specs["shared"] = {"gate": P(None, None), "up": P(None, None),
                             "down": P(None, None)}
    p_in = {k: p[k] for k in p_specs}

    def a2a(t):   # [msize, ...] rows exchanged with the model ranks
        return funcol.all_to_all_single_autograd(t.contiguous(), None, None,
                                                 group)

    def local_fn(p_local, x_local):
        Bl, Sl, dl = x_local.shape
        T = Bl * Sl
        x2d = x_local.reshape(T, dl)
        t_r = max(T // msize, 1)
        start = min(rank * t_r, T - t_r)       # clamped, as dynamic_slice
        xr = x2d[start:start + t_r]
        w, idx, probs = _route(cfg, p_local, xr)
        k = m.top_k
        dest = idx // e_loc                                  # [t_r, k]
        local_eid = idx % e_loc
        # pack send buffers: capacity per destination rank
        C = max(1, int(t_r * k * m.capacity_factor / msize))
        flat_dest = dest.reshape(-1)
        order = torch.argsort(flat_dest, stable=True)
        sorted_dest = flat_dest[order]
        token_of = order // k
        counts = _count(flat_dest, msize)
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(t_r * k, device=x2d.device) - starts[sorted_dest]
        keep = pos < C
        pos_c = torch.where(keep, pos, 0)
        send_x = xr.new_zeros(msize, C, dl).index_put(
            (sorted_dest, pos_c),
            torch.where(keep[:, None], xr[token_of], 0), accumulate=True)
        send_e = torch.zeros(msize, C, dtype=torch.long,
                             device=x2d.device).index_put(
            (sorted_dest, pos_c),
            torch.where(keep, local_eid.reshape(-1)[order] + 1, 0),
            accumulate=True)                                 # 0 = empty
        rx = a2a(send_x).reshape(msize * C, dl)
        re_ = a2a(send_e).reshape(msize * C)
        valid = re_ > 0
        eid = torch.where(valid, re_ - 1, 0)
        # local-expert capacity FFN over the received tokens
        Ce = max(1, int(msize * C * 2 // max(e_loc, 1)))
        key = torch.where(valid, eid, e_loc)                 # invalid last
        ords = torch.argsort(key, stable=True)
        se = eid[ords]
        cnts = _count(key, e_loc + 1)
        sts = torch.cat([(torch.cumsum(cnts, 0) - cnts)[:e_loc],
                         cnts.new_zeros(1)])
        posx = torch.arange(msize * C, device=x2d.device) \
            - sts[torch.clamp(se, max=e_loc)]
        kp = (posx < Ce) & valid[ords]
        px = torch.where(kp, posx, 0)
        row = torch.clamp(se, max=e_loc - 1)
        buf = rx.new_zeros(e_loc, Ce, dl).index_put(
            (row, px), torch.where(kp[:, None], rx[ords], 0),
            accumulate=True)
        g = torch.einsum("ecd,edf->ecf", buf, p_local["w_gate"])
        u = torch.einsum("ecd,edf->ecf", buf, p_local["w_up"])
        h = torch.nn.functional.silu(g.float()).to(buf.dtype) * u
        y_buf = torch.einsum("ecf,efd->ecd", h, p_local["w_down"])
        y_sorted = y_buf[row, px] * kp[:, None].to(y_buf.dtype)
        y_recv = y_buf.new_zeros(msize * C, dl).index_put(
            (ords,), y_sorted, accumulate=True)
        # return trip
        back = a2a(y_recv.reshape(msize, C, dl))
        # unpack to the token slice, apply the combine weights
        y_flat = back[sorted_dest, pos_c] * keep[:, None].to(back.dtype)
        y_flat = y_flat * w.reshape(-1)[order][:, None].to(y_flat.dtype)
        yr = torch.zeros_like(xr).index_put((token_of,), y_flat,
                                            accumulate=True)
        if m.n_shared_experts:
            yr = yr + _shared_experts(p_local["shared"], xr, True)
        return yr, _aux_loss(cfg, probs, idx)[None]

    # the slices are sharded over model on the token axis, inside each
    # data shard; so are the aux losses, whose mean is the pmean
    out = _out_placements(mesh, bspec, Shard(0))
    yr, aux = _local_map(mesh, local_fn, (p_in, x), (p_specs, x_spec),
                         (out, out), bspec)
    # all-gather the slices over model and keep the data shard's first T
    # rows (more when the last ranks' clamped slices repeated tokens)
    whole = _out_placements(mesh, bspec, Replicate())
    sizes = mesh_shape(mesh)
    T = (B // math.prod(sizes[a] for a in bspec) if bspec else B) * S
    y = DTensor.from_local(
        yr.redistribute(mesh, whole).to_local()[:T], mesh, whole,
        run_check=False)
    return y.reshape(B, S, d), aux.mean()
