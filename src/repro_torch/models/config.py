"""Model configuration for the families the port runs.

The fields mirror ``repro.models.config.ModelConfig`` for all six of its
families: the dense GQA transformer (``dense``: RMS norm,
LayerNorm or OLMo's LayerNorm without parameters, a SwiGLU or GELU MLP,
full or sliding-window attention), the fine-grained mixture of experts
(``moe``: the dense decoder's attention with a routed-expert FFN, top-k
token choice plus always-on shared experts, DeepSeek-MoE / Granite
style), the recurrent stack (``ssm``: RWKV6 blocks when the config
carries an ``RWKVConfig``, Mamba2 otherwise), the hybrid (``hybrid``: a
Mamba2 backbone plus ONE weight-shared attention+MLP block applied after
every ``attn_every`` Mamba2 layers, Zamba2-style) and the VLM and audio
stubs (``vlm``, ``audio``: the dense decoder behind a stubbed modality
frontend that supplies ``n_prefix_embeds`` pre-projected embeddings at
``d_model``, which ``forward`` takes as ``prefix_embeds``). The JAX package's
kernel flags (``use_kernels``, ``use_decode_kernel``) have no counterpart:
in the port the device decides, and on a CUDA device the model always
goes through the Hopper kernels. One difference from the JAX config:
the ``moe``, ``ssm`` and ``rwkv`` sub-configs are set only for a family
that reads them (the JAX package chooses the recurrent block by the arch
id). ``SSMConfig.chunk`` is the chunk length of the Mamba2 reference math
(``models/mamba2.py``), as in the JAX package; the SSD kernel chooses its
own.

The port's own :class:`Zamba2Config` (a ``hybrid`` of the published
layout: shared blocks by ``hybrid_layer_ids``, two in turn over [h, x0],
grouped Mamba2 through :class:`GroupedSSMConfig`) adds fields that the
JAX package's configs do not have; the base classes carry their
defaults as plain class attributes, so every other id's fields and
``asdict`` are the JAX config's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..compat import torch_dtype

#: families the port runs: all six of the JAX package's
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
#: the MoE's dispatch implementations (``models/moe.py``)
MOE_IMPLS = ("capacity", "ragged", "dense")
#: decode KV cache storage types
KV_CACHE_DTYPES = ("model", "int8")
#: normalisation layers: RMS norm, LayerNorm with scale and bias, and
#: OLMo's LayerNorm without learned parameters
NORMS = ("rmsnorm", "layernorm", "nonparametric_ln")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    top_k: int = 0
    n_shared_experts: int = 0     # always-on experts (DeepSeek-MoE style)
    d_expert: int = 0             # per-expert FFN hidden size (fine-grained)
    router_aux_coef: float = 0.01  # load-balance loss coefficient
    # dispatch (one of MOE_IMPLS): "capacity" sorts the (token, expert)
    # pairs into a fixed [E, C, d] buffer and drops each expert's overflow;
    # "ragged" is dropless; "dense" runs every expert on every token (the
    # oracle). Decode is dropless whatever this says (models/moe.py).
    impl: str = "capacity"
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64             # Mamba2 SSD state per head
    d_conv: int = 4               # causal conv width
    expand: int = 2               # d_inner = expand * d_model
    head_dim: int = 64            # SSD head dim
    chunk: int = 128              # the reference math's SSD chunk length
                                  # (the SSD kernel picks its own)
    # the JAX package's Mamba2, whose fields these are not (plain class
    # attributes, so that its configs compare field for field):
    # :class:`GroupedSSMConfig` sets them
    n_groups = 1                  # B/C groups, each shared by nh / n_groups
                                  # heads, each with its own gated norm
    dt_min = 0.0                  # floor of softplus(dt + dt_bias); 0: none


@dataclasses.dataclass(frozen=True)
class GroupedSSMConfig(SSMConfig):
    """Mamba2 as published (``mamba_ngroups``, the plain path's floor
    ``time_step_min`` on the step size)."""
    n_groups: int = 1
    dt_min: float = 0.0


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
    # KV-head replication for tensor parallelism (vLLM-style): the K/V
    # projections and every cache (slot, ring, paged, int8) widen to
    # n_kv_eff = n_kv_heads * kv_repeat heads, so each rank of the model
    # axis owns whole KV heads. The replicas are separate weights here, as
    # in the JAX package (whose checkpoints tie them); n_kv_eff must
    # divide n_heads
    kv_repeat: int = 1
    attn_every: int = 1                     # hybrid: shared attn every k
    # attention over the last `sliding_window` positions only (None =
    # full attention); the decode cache is then a ring of that many slots
    sliding_window: Optional[int] = None
    norm: str = "rmsnorm"                   # one of NORMS
    tie_embeddings: bool = False
    gated_mlp: bool = True                  # SwiGLU; False: GELU (up, down)
    moe: Optional[MoEConfig] = None         # set for the moe family
    ssm: Optional[SSMConfig] = None         # set for a Mamba2 backbone
    rwkv: Optional[RWKVConfig] = None       # set for an RWKV6 backbone
    dtype: str = "bfloat16"
    # decode KV cache storage: "model" (= dtype) or "int8" (symmetric
    # absmax quantisation per (position, head), f32 scales beside the
    # codes; the slot cache and the paged pool both)
    kv_cache_dtype: str = "model"
    # modality stub (vlm/audio): number of prefix embedding positions the
    # frontend supplies (pre-projected to d_model); 0 = text-only
    n_prefix_embeds: int = 0
    # activation checkpointing in a forward that records gradients: each
    # block recomputes its activations in the backward pass (a forward
    # that records none, as every serve's, runs as is)
    remat: bool = True
    remat_group: bool = False               # hybrid: checkpoint whole groups
                                            # (attn_every blocks + the shared
                                            # block) rather than single blocks
    source: str = ""

    # The published Zamba2 layout's settings, which the JAX package's
    # configs do not have: plain class attributes here (so that those
    # configs compare field for field), fields of :class:`Zamba2Config`.
    hybrid_layer_ids = ()       # Mamba2 layers a shared block precedes
    num_mem_blocks = 1          # shared blocks, applied in turn
    adapter_rank = 0            # per-application LoRA on the MLP's gate_up
    attn_scale = None           # softmax scale; None: hd ** -0.5
    norm_eps = 1e-6             # every RMS norm's and LayerNorm's eps

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def n_kv_eff(self) -> int:
        """K/V heads the projections and caches hold (``kv_repeat``)."""
        return self.n_kv_heads * self.kv_repeat

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
        if self.family == "moe":
            return ("moe",) * self.n_layers
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

    @property
    def has_attn_layers(self) -> bool:
        """Whether every layer is an attention block (dense or MoE): K/V
        per position in every layer, no recurrent state."""
        return self.backbone_kind in ("attn", "moe")

    @property
    def published_hybrid(self) -> bool:
        """The published Zamba2 layout (:class:`Zamba2Config`)."""
        return bool(self.hybrid_layer_ids)

    def param_count(self) -> int:
        """Analytic parameter count (embedding, blocks, head; norms left
        out), ``repro.models.config.ModelConfig.param_count``'s formula."""
        d, v, hd = self.d_model, self.vocab_size, self.hd
        n = v * d * (1 if self.tie_embeddings else 2)
        attn = (2 * self.n_heads * hd + 2 * self.n_kv_heads * hd) * d
        kind = self.backbone_kind
        if kind == "attn":
            per = attn + d * self.d_ff * (3 if self.gated_mlp else 2)
        elif kind == "moe":
            m = self.moe
            per = attn + (m.n_experts + m.n_shared_experts) * d \
                * m.d_expert * 3 + d * m.n_experts
        elif kind == "mamba2":
            d_in = self.ssm.expand * d
            nh = d_in // self.ssm.head_dim
            per = d * (2 * d_in + 2 * self.ssm.d_state + nh) + d_in * d \
                + self.ssm.d_conv * (d_in + 2 * self.ssm.d_state)
        else:   # rwkv6: wr, wk, wv, wg, wo + cr, channel mix, decay LoRA
            per = d * d * 6 + d * self.d_ff * 2 \
                + d * self.rwkv.decay_lora * 2
        n += per * self.n_layers
        if self.has_shared_attn:
            n += attn + d * self.d_ff * 3
        return n

    def active_param_count(self) -> int:
        """Parameters a token runs through (MoE: shared + top_k routed
        experts)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        per_expert = self.d_model * m.d_expert * 3 * self.n_layers
        return self.param_count() - (m.n_experts - m.top_k) * per_expert

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
        if self.has_attn_layers or self.has_shared_attn:
            if (self.n_heads <= 0 or self.n_kv_heads <= 0
                    or self.n_heads % self.n_kv_heads):
                raise ValueError("GQA grouping needs n_kv_heads | n_heads")
            if self.kv_repeat < 1 or self.n_heads % self.n_kv_eff:
                raise ValueError("kv_repeat must keep n_kv_eff a divisor "
                                 "of n_heads")
        if self.has_shared_attn and self.attn_every < 1:
            raise ValueError("attn_every must be >= 1")
        if self.backbone_kind == "mamba2" and self.ssm is None:
            raise ValueError("a Mamba2 backbone needs an SSMConfig")
        if self.family == "moe":
            m = self.moe
            if m is None or not (m.n_experts > 0 and m.top_k > 0):
                raise ValueError("the moe family needs a MoEConfig with "
                                 "n_experts > 0 and top_k > 0")
            if m.top_k > m.n_experts:
                raise ValueError("top_k must be <= n_experts")
            if m.impl not in MOE_IMPLS:
                raise ValueError(f"MoE impl {m.impl!r} not in {MOE_IMPLS}")
        if self.family in ("vlm", "audio") and self.n_prefix_embeds <= 0:
            raise ValueError("modality stub needs prefix slots "
                             "(n_prefix_embeds > 0)")
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


@dataclasses.dataclass(frozen=True)
class Zamba2Config(ModelConfig):
    """The hybrid as Zamba2 publishes it (``transformers``'
    ``modeling_zamba2``; arXiv:2411.15242, 2405.16712 eq. 6), beside the
    JAX package's one-block layout. ``n_layers`` Mamba2 layers (grouped
    B/C, :class:`GroupedSSMConfig`); before each layer of
    ``hybrid_layer_ids``, application ``j`` of shared block ``j %
    num_mem_blocks``:

        u = RMSNorm([h, x0])               (2 d wide; x0 the embedding)
        a = RMSNorm(Attn(u))               (q, k, v: 2 d -> n_heads x hd)
        t = (GeGLU(a), exact GELU, with the application's
             rank-``adapter_rank`` adapter on gate_up) @ linear_j
        h = h + Mamba2(RMSNorm(h + t))

    and every other layer ``h = h + Mamba2(RMSNorm(h))``. The block adds
    no residual of its own; its output enters the Mamba2 layer's input.
    ``d_ff`` is the MLP's width, ``head_dim`` the attention's (2 d /
    n_heads), ``attn_scale`` its softmax scale."""
    hybrid_layer_ids: tuple = ()
    num_mem_blocks: int = 1
    adapter_rank: int = 0
    attn_scale: Optional[float] = None
    norm_eps: float = 1e-5

    @property
    def n_apps(self) -> int:
        """Applications of the shared blocks (each its own K/V)."""
        return len(self.hybrid_layer_ids)

    def param_count(self) -> int:
        """Embedding (tied head), the Mamba2 layers, the shared blocks,
        and each application's adapter and linear; norms and the Mamba2
        layers' per-head scalars left out, as the base formula does."""
        d, s = self.d_model, self.ssm
        d_in = s.expand * d
        nh, bc = d_in // s.head_dim, 2 * s.n_groups * s.d_state
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        n += self.n_layers * (d * (2 * d_in + bc + nh) + d_in * d
                              + s.d_conv * (d_in + bc))
        qkv = 2 * d * (self.n_heads + 2 * self.n_kv_heads) * self.hd
        block = qkv + self.n_heads * self.hd * d + 3 * d * self.d_ff
        n += self.num_mem_blocks * block
        return n + self.n_apps * (self.adapter_rank * (d + 2 * self.d_ff)
                                  + d * d)

    def validate(self, paged: bool = False) -> None:
        super().validate(paged)
        ids = self.hybrid_layer_ids
        if not ids or list(ids) != sorted(set(ids)) or ids[0] < 0 \
                or ids[-1] >= self.n_layers:
            raise ValueError("hybrid_layer_ids must be distinct, increasing "
                             "layer indices")
        if self.num_mem_blocks < 1:
            raise ValueError("num_mem_blocks must be >= 1")
        if self.ssm is None or (self.ssm.expand * self.d_model
                                // self.ssm.head_dim) % self.ssm.n_groups:
            raise ValueError("the B/C groups must divide the SSD heads")


def reduced(cfg: ModelConfig, n_layers: int = 2,
            d_model: int = 256) -> ModelConfig:
    """Small variant of the same family for CPU tests (2 layers, d_model 256,
    f32, a sliding window cut to 64, at most 8 prefix embeddings, no
    activation checkpointing; a MoE at most 4 experts, top-2, one shared
    expert, capacity factor 8; an SSD chunk of 32), the same reduction as
    ``repro.models.config.reduced``. The published Zamba2 layout keeps its
    [h, x0] attention width (head_dim 2 d / n_heads, scale (hd / 2) **
    -0.5), with shared blocks before layers 0 and 1 and adapters of rank
    at most 8."""
    scale = d_model / cfg.d_model
    n_heads = max(1, min(cfg.n_heads, 4))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    ssm = cfg.ssm and dataclasses.replace(
        cfg.ssm, d_state=min(cfg.ssm.d_state, 16), head_dim=32, chunk=32)
    extra = {}
    if cfg.published_hybrid:     # the shared blocks before layers 0 .. 1
        extra = dict(hybrid_layer_ids=tuple(i for i in (0, 1)
                                            if i < n_layers),
                     adapter_rank=min(cfg.adapter_rank, 8),
                     attn_scale=(d_model // n_heads) ** -0.5)
    rwkv = cfg.rwkv and dataclasses.replace(cfg.rwkv, head_dim=32,
                                            decay_lora=16)
    moe = cfg.moe and dataclasses.replace(
        cfg.moe, n_experts=min(cfg.moe.n_experts, 4),   # <= 4 experts
        top_k=min(cfg.moe.top_k, 2),
        n_shared_experts=min(cfg.moe.n_shared_experts, 1),
        d_expert=max(32, int(cfg.moe.d_expert * scale)),
        capacity_factor=8.0)   # smoke tests: effectively dropless
    return dataclasses.replace(
        cfg,
        arch_id=cfg.arch_id + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=(2 if cfg.published_hybrid else 1) * d_model // n_heads,
        d_ff=max(64, int(cfg.d_ff * scale)),
        vocab_size=min(cfg.vocab_size, 512),
        sliding_window=(64 if cfg.sliding_window else None),
        n_prefix_embeds=min(cfg.n_prefix_embeds, 8),
        moe=moe, ssm=ssm, rwkv=rwkv,
        dtype="float32",
        remat=False,
        **extra,
    )
