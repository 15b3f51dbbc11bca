"""OLMo-1B: dense decoder with non-parametric LayerNorm (no learned affine),
tied embeddings. [arXiv:2402.00838]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="olmo-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab_size=50304,
        norm="nonparametric_ln",
        tie_embeddings=True,
        source="arXiv:2402.00838",
    )
