"""Qwen3-8B: the paper's own serving model (Sec IV numerics calibrated on
it); dense GQA decoder with qk-norm, untied. [arXiv:2505.09388]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen3-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        source="arXiv:2505.09388",
    )
