"""Zamba2-7B: Mamba2 backbone + periodically applied weight-shared attention
block (hybrid). [arXiv:2411.15242]"""
from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        head_dim=112,
        d_ff=14336,
        vocab_size=32000,
        attn_every=6,           # shared attn+MLP block every 6 Mamba2 blocks
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                      chunk=256),
        source="arXiv:2411.15242",
    )
