"""RWKV6-1.6B ("Finch"): attention-free, data-dependent decay linear
attention. [arXiv:2404.05892]"""
from repro_torch.models.config import ModelConfig, RWKVConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="rwkv6-1.6b",
        family="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=0,
        n_kv_heads=0,
        d_ff=7168,
        vocab_size=65536,
        rwkv=RWKVConfig(head_dim=64, decay_lora=64),
        source="arXiv:2404.05892",
    )
