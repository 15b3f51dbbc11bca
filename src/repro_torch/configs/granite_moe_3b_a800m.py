"""Granite-3.0 MoE 3B-A800M: 40 experts top-8 (structured assignment spec;
the bracketed hf card is the smaller sibling).
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        moe=MoEConfig(n_experts=40, top_k=8, n_shared_experts=0,
                      d_expert=512),
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )
