"""Model configuration for the dense decoder slice of the port.

The fields mirror ``repro.models.config.ModelConfig`` for the dense GQA
transformer the port runs: RMS norm, SwiGLU MLP, tied embeddings, full
(not sliding-window) attention. The JAX package's kernel flags
(``use_kernels``, ``use_decode_kernel``) have no counterpart: in the port
the device decides, and on a CUDA device the model always goes through
the Hopper kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..compat import torch_dtype


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int                  # query heads
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def tdtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def padded_vocab(self) -> int:
        """Computation vocab: padded up to a multiple of 128. Padded rows are
        never valid targets; the sampler masks them."""
        return ((self.vocab_size + 127) // 128) * 128

    def validate(self) -> None:
        if self.family != "dense":
            raise NotImplementedError(
                f"family {self.family!r} is not ported; only dense is")
        if not (self.d_model > 0 and self.n_layers > 0 and self.vocab_size > 0):
            raise ValueError("d_model, n_layers and vocab_size must be > 0")
        if self.n_heads <= 0 or self.n_heads % self.n_kv_heads:
            raise ValueError("GQA grouping needs n_kv_heads | n_heads")


def reduced(cfg: ModelConfig, n_layers: int = 2,
            d_model: int = 256) -> ModelConfig:
    """Small variant of the same family for CPU tests (2 layers, d_model 256,
    f32), the same reduction as ``repro.models.config.reduced``."""
    scale = d_model / cfg.d_model
    n_heads = max(1, min(cfg.n_heads, 4))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    return dataclasses.replace(
        cfg,
        arch_id=cfg.arch_id + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=d_model // n_heads,
        d_ff=max(64, int(cfg.d_ff * scale)),
        vocab_size=min(cfg.vocab_size, 512),
        dtype="float32",
    )
