"""Shared layers: the norms (RMS norm, LayerNorm, OLMo's LayerNorm without
parameters), embedding, RoPE, the SwiGLU and GELU MLPs, lm_head (tied or
untied)."""
from __future__ import annotations

import torch

from ..compat import acc
from ..kernels import ops as kops
from .config import ModelConfig

Tensor = torch.Tensor


def _he(gen: torch.Generator, shape, dtype, fan_in: int) -> Tensor:
    """N(0, 1) * sqrt(2 / fan_in) / 2, drawn in f32 on the generator's
    device and cast (the scale of ``repro.models.layers._he``)."""
    scale = (2.0 / max(fan_in, 1)) ** 0.5 / 2.0
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * scale).to(dtype)


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
    """The config's norm over the last axis, in f32 with eps 1e-6."""
    xf = acc(x)
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                             + 1e-6)
        return (y * acc(p["scale"])).to(x.dtype)
    xc = xf - torch.mean(xf, dim=-1, keepdim=True)
    y = xc * torch.rsqrt(torch.mean(xc * xc, dim=-1, keepdim=True) + 1e-6)
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
    return p["tok"][tokens.long()]


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
