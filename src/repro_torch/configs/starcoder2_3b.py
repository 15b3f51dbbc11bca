"""StarCoder2-3B: dense decoder, GQA kv=2, RoPE, sliding-window attention
(window 4096), GELU MLP, LayerNorm. [arXiv:2402.19173]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        norm="layernorm",
        gated_mlp=False,
        sliding_window=4096,
        rope_theta=100_000.0,
        source="arXiv:2402.19173",
    )
