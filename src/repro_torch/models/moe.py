"""Fine-grained Mixture-of-Experts (DeepSeek-MoE / Granite style).

The port of ``repro.models.moe``'s single-device path (its
``_moe_local``; the ``shard_map`` paths come with ``sharding/``). Shared
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

The (token, slot) ranks come from a cumulative count of a one-hot over the
experts, not from a sort, and the group sizes from its sum (``bincount``
on the card would read its maximum back to the host). The outputs are
combined without atomics: each pair's output is gathered back to
``[T, k, d]`` and summed over k in slot order, so two runs of a step (the
eager one and its replayed graph) give the same bits. ``moe_forward``
adds the switch-style load-balance loss ``E * sum_e f_e P_e * coef`` of
the routing; the decode step calls ``moe_apply``, which leaves it out.

Entry points: ``moe_forward(cfg, p, x, force_ref=False) -> (y, aux)``,
``moe_apply(cfg, p, x, force_ref=False) -> (y, probs, experts)``.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops
from ..kernels import ref
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
    read."""
    flat_e = idx.reshape(-1)
    hit = (flat_e[:, None] == torch.arange(n_experts, device=idx.device)) \
        .to(torch.int32)                                       # [T k, E]
    before = torch.cumsum(hit, 0) - hit
    pos = before.gather(1, flat_e[:, None])[:, 0]
    return flat_e, pos, hit.sum(0, dtype=torch.int32)


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
    flat_e, pos, group_sizes = _expert_ranks(E, idx)
    keep = pos < C
    slot = flat_e * C + pos                     # row of the flat buffer
    # a dropped pair writes to a spare row past the buffer and reads pair
    # 0's row (rank 0 < C: always kept), so no unwritten row is read
    buf = x2d.new_zeros(E * C + 1, d)
    buf.index_copy_(0, torch.where(keep, slot, E * C),
                    x2d[:, None].expand(T, k, d).reshape(T * k, d))
    y = kops.fused_ffn(buf[:E * C].view(E, C, d), p["w_gate"], p["w_up"],
                       p["w_down"], rows=group_sizes.clamp(max=C),
                       force_ref=force_ref)
    y = y.reshape(E * C, d).index_select(0, torch.where(keep, slot, slot[0]))
    wk = torch.where(keep, w.reshape(-1), torch.zeros_like(w.reshape(-1)))
    return (y * wk[:, None]).view(T, k, d).sum(1)


def _moe_capacity(cfg: ModelConfig, p: dict, x2d: Tensor, w: Tensor,
                  idx: Tensor, force_ref: bool = False) -> Tensor:
    """GShard/Switch-style capacity dispatch, dropping each expert's pairs
    past ``C = max(1, int(T k cf / E))`` (C from static shapes)."""
    m = cfg.moe
    T, k = idx.shape
    C = max(1, int(T * k * m.capacity_factor / m.n_experts))
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
    and the load-balance loss of its routing."""
    y, probs, idx = moe_apply(cfg, p, x, force_ref=force_ref)
    return y, _aux_loss(cfg, probs, idx)
