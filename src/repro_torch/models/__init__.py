"""Dense GQA decoder (the slice of ``repro.models`` the serving path runs)."""
from .attention import KVCache, init_cache
from .config import ModelConfig, reduced
from .sampling import sample
from .transformer import ModelOutput, decode_step, forward, init_params

__all__ = ["ModelConfig", "reduced", "init_params", "forward", "decode_step",
           "ModelOutput", "sample", "KVCache", "init_cache"]
