"""Shared layers: RMS norm, embedding, RoPE, SwiGLU MLP, lm_head (tied or
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
    return {"scale": torch.ones(lead + (cfg.d_model,), dtype=cfg.tdtype,
                                device=device)}


def apply_norm(cfg: ModelConfig, p: dict, x: Tensor) -> Tensor:
    xf = acc(x)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return (y * acc(p["scale"])).to(x.dtype)


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
    d, f = cfg.d_model, cfg.d_ff
    return {"up": _he(gen, lead + (d, f), cfg.tdtype, fan_in=d),
            "down": _he(gen, lead + (f, d), cfg.tdtype, fan_in=f),
            "gate": _he(gen, lead + (d, f), cfg.tdtype, fan_in=d)}


def apply_mlp(cfg: ModelConfig, p: dict, x: Tensor,
              force_ref: bool = False) -> Tensor:
    """SwiGLU MLP. Goes through the fused FFN kernel (its plain version on
    the CPU) at every shape; ``force_ref`` takes the JAX package's unfused
    einsum path instead."""
    if force_ref:
        up = torch.matmul(x, p["up"])
        gate = torch.matmul(x, p["gate"])
        h = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
        return torch.matmul(h, p["down"])
    B, S, d = x.shape
    y = kops.fused_ffn(x.reshape(1, B * S, d), p["gate"][None],
                       p["up"][None], p["down"][None])
    return y.reshape(B, S, d)
