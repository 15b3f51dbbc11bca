"""Qwen3-0.6B: dense GQA decoder with qk-norm. [hf:Qwen/Qwen3-8B family]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen3-0.6b",
        family="dense",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,           # Qwen3 uses head_dim 128 (nh*hd != d_model)
        d_ff=3072,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        source="hf:Qwen/Qwen3-8B",
    )
