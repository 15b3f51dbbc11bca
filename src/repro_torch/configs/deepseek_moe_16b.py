"""DeepSeek-MoE-16B: fine-grained MoE, 64 routed experts top-6 + 2 shared.
[arXiv:2401.06066]"""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=102400,
        moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2,
                      d_expert=1408),
        source="arXiv:2401.06066",
    )
