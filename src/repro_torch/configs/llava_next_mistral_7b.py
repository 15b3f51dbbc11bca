"""LLaVA-NeXT (Mistral-7B backbone): VLM with anyres tiling. The SigLIP/CLIP
vision tower + projector are a STUB: the caller supplies pre-projected
patch embeddings (anyres grid flattened) at d_model as ``prefix_embeds``.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="llava-next-mistral-7b",
        family="vlm",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        rope_theta=1_000_000.0,
        n_prefix_embeds=1152,   # 2 anyres tiles x 576 patches (stub frontend)
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    )
