"""Zamba2-7B-Instruct as published (``config.json`` of
https://huggingface.co/Zyphra/Zamba2-7B-Instruct; arXiv:2411.15242): 81
Mamba2 layers with 2 B/C groups, and two weight-shared attention + GeGLU
blocks applied alternately before layers 6, 11, 17, ..., 77 over the
concatenation of the stream and the embedding, each application with its
own gate_up adapter and output linear. A port-only id: the JAX package's
``zamba2-7b`` (one block, SwiGLU, 1 group) stays as it is.

Where the published code leaves a choice (``departures``):

* the step size is floored at ``time_step_min`` = 0.001, as
  ``transformers``' plain Mamba2 path does in prefill and decode (its CUDA
  path, with ``time_step_limit`` null, floors nothing);
* the head is tied to the embedding (``transformers``' default; the
  config names no ``tie_word_embeddings``);
* the SSD state is kept in f32, whatever the weights' dtype;
* each application's rank-128 gate_up adapter is applied as two skinny
  products (13 x 4.1 M weights), not merged into 13 copies of gate_up
  (13 x 102.8 M).
"""
from repro_torch.models.config import GroupedSSMConfig, Zamba2Config

HYBRID_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)


def config() -> Zamba2Config:
    return Zamba2Config(
        arch_id="zamba2-7b-instruct",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        head_dim=224,               # attention_head_dim: 2 x 3584 / 32
        d_ff=14336,
        vocab_size=32000,
        rope_theta=10_000.0,
        tie_embeddings=True,
        ssm=GroupedSSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                             chunk=256, n_groups=2, dt_min=0.001),
        hybrid_layer_ids=HYBRID_LAYER_IDS,
        num_mem_blocks=2,
        adapter_rank=128,
        attn_scale=(224 / 2) ** -0.5,
        norm_eps=1e-5,
        source="https://huggingface.co/Zyphra/Zamba2-7B-Instruct",
    )
