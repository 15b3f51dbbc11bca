"""Model configuration for the families the port runs.

The fields mirror ``repro.models.config.ModelConfig`` for the three
families that are ported: the dense GQA transformer (``dense``: RMS norm,
LayerNorm or OLMo's LayerNorm without parameters, a SwiGLU or GELU MLP,
full or sliding-window attention), the recurrent stack (``ssm``: RWKV6 blocks
when the config carries an ``RWKVConfig``, Mamba2 otherwise) and the hybrid (``hybrid``: a
Mamba2 backbone plus ONE weight-shared attention+MLP block applied after
every ``attn_every`` Mamba2 layers, Zamba2-style). The JAX package's
kernel flags (``use_kernels``, ``use_decode_kernel``) have no counterpart:
in the port the device decides, and on a CUDA device the model always
goes through the Hopper kernels. Two differences from the JAX config:
the ``ssm`` and ``rwkv`` sub-configs are set only for a family that reads
them (the JAX package chooses the recurrent block by the arch id), and
``SSMConfig`` has no chunk length, since the SSD kernel chooses its own.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..compat import torch_dtype

#: families the port runs; the JAX package's others raise in ``validate``
PORTED_FAMILIES = ("dense", "ssm", "hybrid")
#: decode KV cache storage types
KV_CACHE_DTYPES = ("model", "int8")
#: normalisation layers: RMS norm, LayerNorm with scale and bias, and
#: OLMo's LayerNorm without learned parameters
NORMS = ("rmsnorm", "layernorm", "nonparametric_ln")


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64             # Mamba2 SSD state per head
    d_conv: int = 4               # causal conv width
    expand: int = 2               # d_inner = expand * d_model
    head_dim: int = 64            # SSD head dim (the SSD kernel picks its
                                  # own chunk length)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64          # rank of the data-dependent decay LoRA


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int                  # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    attn_every: int = 1                     # hybrid: shared attn every k
    # attention over the last `sliding_window` positions only (None =
    # full attention); the decode cache is then a ring of that many slots
    sliding_window: Optional[int] = None
    norm: str = "rmsnorm"                   # one of NORMS
    tie_embeddings: bool = False
    gated_mlp: bool = True                  # SwiGLU; False: GELU (up, down)
    ssm: Optional[SSMConfig] = None         # set for a Mamba2 backbone
    rwkv: Optional[RWKVConfig] = None       # set for an RWKV6 backbone
    dtype: str = "bfloat16"
    # decode KV cache storage: "model" (= dtype) or "int8" (symmetric
    # absmax quantisation per (position, head), f32 scales beside the
    # codes; the slot cache and the paged pool both)
    kv_cache_dtype: str = "model"
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

    @property
    def block_kinds(self) -> tuple:
        """Per-layer block kinds. The hybrid stack is a Mamba2 backbone; its
        shared attention block is not one of the layers."""
        if self.family == "ssm":
            kind = "rwkv6" if self.rwkv is not None else "mamba2"
            return (kind,) * self.n_layers
        if self.family == "hybrid":
            return ("mamba2",) * self.n_layers
        return ("attn",) * self.n_layers

    @property
    def backbone_kind(self) -> str:
        return self.block_kinds[0]

    @property
    def has_shared_attn(self) -> bool:
        return self.family == "hybrid"

    def validate(self, paged: bool = False) -> None:
        """Raise for a config the port cannot run; ``paged``: also for one
        the paged KV pool cannot hold (a sliding window keeps a ring of
        slots, which blocks do not address)."""
        if self.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"family {self.family!r} is not ported; the port runs "
                f"{', '.join(PORTED_FAMILIES)}")
        if not (self.d_model > 0 and self.n_layers > 0 and self.vocab_size > 0):
            raise ValueError("d_model, n_layers and vocab_size must be > 0")
        if self.backbone_kind == "attn" or self.has_shared_attn:
            if (self.n_heads <= 0 or self.n_kv_heads <= 0
                    or self.n_heads % self.n_kv_heads):
                raise ValueError("GQA grouping needs n_kv_heads | n_heads")
        if self.has_shared_attn and self.attn_every < 1:
            raise ValueError("attn_every must be >= 1")
        if self.backbone_kind == "mamba2" and self.ssm is None:
            raise ValueError("a Mamba2 backbone needs an SSMConfig")
        if self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype {self.kv_cache_dtype!r} not in "
                             f"{KV_CACHE_DTYPES}")
        if self.norm not in NORMS:
            raise ValueError(f"norm {self.norm!r} not in {NORMS}")
        if self.sliding_window is not None and self.sliding_window < 1:
            raise ValueError("sliding_window must be >= 1")
        if paged and self.sliding_window is not None:
            raise ValueError("paged KV requires full attention; a sliding "
                             "window keeps the dense ring cache")


def reduced(cfg: ModelConfig, n_layers: int = 2,
            d_model: int = 256) -> ModelConfig:
    """Small variant of the same family for CPU tests (2 layers, d_model 256,
    f32, a sliding window cut to 64), the same reduction as
    ``repro.models.config.reduced``."""
    scale = d_model / cfg.d_model
    n_heads = max(1, min(cfg.n_heads, 4))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    ssm = cfg.ssm and dataclasses.replace(
        cfg.ssm, d_state=min(cfg.ssm.d_state, 16), head_dim=32)
    rwkv = cfg.rwkv and dataclasses.replace(cfg.rwkv, head_dim=32,
                                            decay_lora=16)
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
        sliding_window=(64 if cfg.sliding_window else None),
        ssm=ssm, rwkv=rwkv,
        dtype="float32",
    )
