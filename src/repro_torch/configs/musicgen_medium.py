"""MusicGen-medium: decoder-only transformer over EnCodec audio tokens.
The mel/EnCodec conv frontend is a STUB: the caller supplies precomputed
conditioning frame embeddings (n_prefix_embeds) at d_model as
``prefix_embeds``. [arXiv:2306.05284]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        gated_mlp=False,        # MusicGen uses GELU MLP
        norm="layernorm",
        n_prefix_embeds=64,     # conditioning frames from the stubbed frontend
        source="arXiv:2306.05284",
    )
