"""Dense GQA decoder (the slice of ``repro.models`` the serving paths run)."""
from .attention import (KVCache, PagedKVCache, init_cache,
                        init_paged_cache)
from .config import ModelConfig, reduced
from .sampling import fold_sample, sample
from .transformer import ModelOutput, decode_step, forward, init_params

__all__ = ["ModelConfig", "reduced", "init_params", "forward", "decode_step",
           "ModelOutput", "sample", "fold_sample", "KVCache", "init_cache",
           "PagedKVCache", "init_paged_cache"]
