"""StableLM-3B: dense decoder, LayerNorm, full MHA (kv=32).
[hf:stabilityai/stablelm-2-1_6b family]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=6912,
        vocab_size=50304,
        norm="layernorm",
        source="hf:stabilityai/stablelm-2-1_6b",
    )
