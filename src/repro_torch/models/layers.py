"""Shared layers: the norms (RMS norm, LayerNorm, OLMo's LayerNorm without
parameters), embedding, RoPE, the SwiGLU and GELU MLPs, the published
Zamba2's adapted GeGLU, lm_head (tied or untied)."""
from __future__ import annotations

import torch

from ..compat import acc, is_dtensor
from ..kernels import ops as kops
from .config import ModelConfig

Tensor = torch.Tensor


def _he(gen: torch.Generator, shape, dtype, fan_in: int) -> Tensor:
    """N(0, 1) * sqrt(2 / fan_in) / 2, drawn in f32 on the generator's
    device and cast (the scale of ``repro.models.layers._he``)."""
    scale = (2.0 / max(fan_in, 1)) ** 0.5 / 2.0
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * scale).to(dtype)


def split_dim(t: Tensor, dim: int, sizes: tuple) -> Tensor:
    """``t.unflatten(dim, sizes)``. On a DTensor whose ``dim`` is sharded
    over a mesh dimension that ``sizes[0]`` does not divide (qwen3's 8 KV
    heads a 16-wide model axis), DTensor has no layout for the result and
    refuses the view; that mesh dimension is replicated first (GSPMD
    reshards such a reshape by itself)."""
    if is_dtensor(t):
        pls = t.placements
        from torch.distributed.tensor import Replicate
        d = dim % t.dim()
        mesh = t.device_mesh
        new = tuple(Replicate() if p.is_shard(d) and sizes[0] % mesh.size(i)
                    else p for i, p in enumerate(pls))
        if new != tuple(pls):
            t = t.redistribute(mesh, new)
    return t.unflatten(dim, sizes)


def merge_dims(t: Tensor, start: int, end: int) -> Tensor:
    """``t.flatten(start, end)``. A DTensor keeps a shard of the merged
    dimension only on ``start`` and only where the mesh dimension divides
    it (a head count that does not divide the model axis gets uneven
    shards, which DTensor cannot flatten); other shards of the merged
    dimensions are replicated first, as in :func:`split_dim`."""
    if is_dtensor(t):
        pls = t.placements
        from torch.distributed.tensor import Replicate
        lo, hi = start % t.dim(), end % t.dim()
        mesh = t.device_mesh
        new = tuple(
            Replicate() if any(p.is_shard(d) for d in range(lo, hi + 1))
            and not (p.is_shard(lo) and t.shape[lo] % mesh.size(i) == 0)
            else p for i, p in enumerate(pls))
        if new != tuple(pls):
            t = t.redistribute(mesh, new)
    return t.flatten(start, end)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward hands on a contiguous gradient."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def on_local_heads(fn, args: tuple, batch_dims: tuple, head_dims: tuple,
                   out_dims: tuple):
    """``fn(*args)`` on each rank's shards of DTensor ``args``
    (``local_map``), for work independent across the batch rows and the
    heads (attention, the scans). Per mesh dimension: where the first
    argument's batch dimension is split, every argument's batch dimension
    is; else, on ``model``, where the axis divides every head count, every
    argument's head dimension is; else all is replicated there, and where
    an argument is split there (qwen3's KV cache over the head dimension
    when its 8 KV heads do not divide a 16-wide model axis) this returns
    None: gathering it would move what the JAX package keeps sharded, and
    the caller runs the work on DTensors instead. ``batch_dims`` /
    ``head_dims``: each argument's dimension or None (not batched or not
    per head: replicated there); ``out_dims``: (batch, head) dimension of
    each output. A plain tensor argument is taken as replicated.

    On DTensors directly, the reshapes inside such work merge two split
    dimensions into strided shards, for which DTensor plans every
    redistribution by a search over layouts that costs more than the
    work; and a sequential scan would pay DTensor's dispatch each step."""
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import local_map
    lead = args[0]
    mesh = lead.device_mesh
    modes = []
    for i, name in enumerate(mesh.mesh_dim_names):
        if lead.placements[i] == Shard(batch_dims[0]):
            modes.append("batch")
        elif name == "model" and all(
                hd is None or a.shape[hd] % mesh.size(i) == 0
                for a, hd in zip(args, head_dims)):
            modes.append("heads")
        elif any(is_dtensor(a) and not a.placements[i].is_replicate()
                 for a in args):
            return None
        else:
            modes.append(None)

    def pls(bd, hd, whole=Replicate()):
        # ``whole``: an argument the ranks that split a dimension it lacks
        # all read whole; its gradient there is each rank's part (Partial)
        return tuple(
            (Shard(bd) if bd is not None else whole) if m == "batch"
            else (Shard(hd) if hd is not None else whole) if m == "heads"
            else Replicate() for m in modes)

    def local(*a):
        # contiguous outputs, and gradients of the inputs made contiguous:
        # DTensor views a gradient's local shard as it is
        out = fn(*(_ContiguousGrad.apply(t) if t.requires_grad else t
                   for t in a))
        if isinstance(out, tuple):
            return tuple(t.contiguous() for t in out)
        return out.contiguous()
    args = tuple(a if is_dtensor(a) else distribute_tensor(
        a, mesh, [Replicate()] * mesh.ndim, src_data_rank=None)
        for a in args)
    dims = tuple(zip(batch_dims, head_dims))
    return local_map(local,
                     out_placements=tuple(pls(bd, hd) for bd, hd in out_dims),
                     in_placements=tuple(pls(bd, hd) for bd, hd in dims),
                     in_grad_placements=tuple(pls(bd, hd, Partial())
                                              for bd, hd in dims),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


# ----------------------------------------------------------------- norms
def init_norm(cfg: ModelConfig, lead: tuple, device) -> dict:
    """``scale`` (RMS norm), ``scale`` and ``bias`` (LayerNorm), or nothing
    (OLMo's non-parametric LayerNorm), each leaf stacked on ``lead``."""
    if cfg.norm == "nonparametric_ln":
        return {}

    def full(value):
        return torch.full(lead + (cfg.d_model,), value, dtype=cfg.tdtype,
                          device=device)
    if cfg.norm == "layernorm":
        return {"scale": full(1.0), "bias": full(0.0)}
    return {"scale": full(1.0)}


def apply_norm(cfg: ModelConfig, p: dict, x: Tensor) -> Tensor:
    """The config's norm over the last axis (any width its scale has), in
    f32 with the config's eps (1e-6 but for the published Zamba2's
    1e-5)."""
    xf = acc(x)
    eps = cfg.norm_eps
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                             + eps)
        return (y * acc(p["scale"])).to(x.dtype)
    xc = xf - torch.mean(xf, dim=-1, keepdim=True)
    y = xc * torch.rsqrt(torch.mean(xc * xc, dim=-1, keepdim=True) + eps)
    if cfg.norm == "layernorm":
        y = y * acc(p["scale"]) + acc(p["bias"])
    return y.to(x.dtype)


# ------------------------------------------------------------- embedding
def init_embed(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Embedding table ``tok [V, d]``; with untied embeddings also the head
    ``head [d, V]`` (a tied lm_head reads ``tok`` transposed)."""
    p = {"tok": _he(gen, (cfg.padded_vocab, cfg.d_model), cfg.tdtype,
                    fan_in=cfg.d_model)}
    if not cfg.tie_embeddings:
        p["head"] = _he(gen, (cfg.d_model, cfg.padded_vocab), cfg.tdtype,
                        fan_in=cfg.d_model)
    return p


def embed_tokens(cfg: ModelConfig, p: dict, tokens: Tensor) -> Tensor:
    if is_dtensor(p["tok"]):
        return _embed_sharded(p["tok"], tokens)
    return p["tok"][tokens.long()]


def _embed_sharded(table: Tensor, tokens: Tensor) -> Tensor:
    """The lookup on a DTensor table on local shards (``local_map``): a
    vocab-parallel table (``Shard(0)``) gathers the rank's own rows, zero
    elsewhere, and hands back a ``Partial`` sum (the JAX package's
    vocab-parallel embedding under GSPMD); a table split on ``d`` gives
    rows split on ``d``. DTensor's own index on the table has, in some
    PyTorch versions, a backward (``index_put``) its sharding rule
    rejects."""
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    if not is_dtensor(tokens):
        tokens = distribute_tensor(tokens, mesh, [Replicate()] * mesh.ndim,
                                   src_data_rank=None)
    tab_pl, tok_pl, out_pl, grad_pl, vocab_dims = [], [], [], [], []
    for i, tp in enumerate(table.placements):
        split = tokens.placements[i] == Shard(0)
        tok_pl.append(Shard(0) if split else Replicate())
        # the table keeps a split of rows or columns where the tokens
        # are whole; elsewhere it is read whole
        tp = tp if tp.is_shard() and not split else Replicate()
        tab_pl.append(tp)
        if tp == Shard(0):
            out_pl.append(Partial())
            vocab_dims.append(i)
        elif tp == Shard(1):
            out_pl.append(Shard(2))
        else:
            out_pl.append(tok_pl[-1])
        grad_pl.append(Partial() if split and tp.is_replicate() else tp)
    lo = 0
    for i in vocab_dims:       # the first row of this rank's shard
        lo = lo * mesh.size(i) + mesh.get_local_rank(i)

    def lookup(rows, tok):
        tok = tok.long()
        if not vocab_dims:
            return rows[tok]
        idx = tok - lo * rows.shape[0]
        hit = (idx >= 0) & (idx < rows.shape[0])
        out = rows[idx.clamp(0, rows.shape[0] - 1)]
        return torch.where(hit[..., None], out, torch.zeros_like(out))
    return local_map(lookup, out_placements=(tuple(out_pl),),
                     in_placements=(tuple(tab_pl), tuple(tok_pl)),
                     in_grad_placements=(tuple(grad_pl), tuple(tok_pl)),
                     device_mesh=mesh, redistribute_inputs=True)(
        table, tokens)


def lm_head(cfg: ModelConfig, p: dict, x: Tensor) -> Tensor:
    """Logits over the padded vocab; entries >= vocab_size are masked to a
    large negative so sampling never selects padding rows. A plain large
    matmul, left to PyTorch as the JAX package left it to XLA."""
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    logits = torch.matmul(x, w)
    if cfg.padded_vocab != cfg.vocab_size:
        valid = torch.arange(cfg.padded_vocab, device=x.device) \
            < cfg.vocab_size
        logits = torch.where(valid, logits,
                             torch.full_like(logits, -1e30))
    return logits


# ------------------------------------------------------------------ RoPE
def rope_freqs(cfg: ModelConfig, positions: Tensor) -> tuple:
    """positions [..., S] -> (cos, sin) each [..., S, hd/2], f32."""
    hd = cfg.hd
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, hd, 2, dtype=torch.float32, device=positions.device) / hd))
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x [..., S, H, hd]; cos/sin [..., S, hd/2] broadcast over heads."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ------------------------------------------------------------------- MLP
def init_mlp(cfg: ModelConfig, gen: torch.Generator, lead: tuple) -> dict:
    """``up`` and ``down``, and ``gate`` for the SwiGLU MLP."""
    d, f = cfg.d_model, cfg.d_ff
    p = {"up": _he(gen, lead + (d, f), cfg.tdtype, fan_in=d),
         "down": _he(gen, lead + (f, d), cfg.tdtype, fan_in=f)}
    if cfg.gated_mlp:
        p["gate"] = _he(gen, lead + (d, f), cfg.tdtype, fan_in=d)
    return p


def apply_mlp(cfg: ModelConfig, p: dict, x: Tensor,
              force_ref: bool = False) -> Tensor:
    """SwiGLU MLP through the fused FFN kernel (its plain version on the
    CPU) at every shape; ``force_ref`` takes the JAX package's unfused
    einsum path instead. The GELU MLP (``gated_mlp=False``: up, GELU in
    f32 with the tanh approximation that ``jax.nn.gelu`` defaults to,
    down) is PyTorch's matmuls in both cases, as in the JAX package, whose
    fused kernel is SwiGLU only."""
    if not cfg.gated_mlp:
        up = torch.matmul(x, p["up"])
        h = torch.nn.functional.gelu(acc(up), approximate="tanh")
        return torch.matmul(h.to(x.dtype), p["down"])
    if force_ref:
        up = torch.matmul(x, p["up"])
        gate = torch.matmul(x, p["gate"])
        h = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
        return torch.matmul(h, p["down"])
    B, S, d = x.shape
    y = kops.fused_ffn(x.reshape(1, B * S, d), p["gate"][None],
                       p["up"][None], p["down"][None])
    return y.reshape(B, S, d)


def apply_adapted_glu(cfg: ModelConfig, p: dict, lora_a: Tensor,
                      lora_b: Tensor, x: Tensor) -> Tensor:
    """The published Zamba2 MLP: ``gate_up [d, 2 f]`` plus the
    application's adapter ``lora_a [d, r] @ lora_b [r, 2 f]`` (two skinny
    products), the first half through the exact GELU (in f32) times the
    second, then ``down``. PyTorch's matmuls."""
    gu = torch.matmul(x, p["gate_up"]) \
        + torch.matmul(torch.matmul(x, lora_a), lora_b)
    g, u = gu.chunk(2, dim=-1)
    return torch.matmul(torch.nn.functional.gelu(acc(g)).to(x.dtype) * u,
                        p["down"])
