"""The ported model families: the dense GQA decoder (RMS norm or LayerNorm,
SwiGLU or GELU MLP, full or sliding-window attention), the fine-grained
mixture of experts, RWKV6 and the Mamba2 + shared-attention hybrid (the
slices of ``repro.models`` the serving paths run), and the hybrid as
Zamba2 publishes it (``zamba2.py``)."""
from .attention import (KVCache, PagedKVCache, QuantKVCache, init_cache,
                        init_paged_cache)
from .config import ModelConfig, reduced
from .mamba2 import MambaCache
from .rwkv6 import RWKVCache
from .sampling import fold_sample, sample
from .transformer import (ModelOutput, decode_step, forward,
                          init_decode_cache, init_paged_decode_cache,
                          init_params)

__all__ = ["ModelConfig", "reduced", "init_params", "forward", "decode_step",
           "init_decode_cache", "init_paged_decode_cache", "ModelOutput",
           "sample", "fold_sample",
           "KVCache", "QuantKVCache", "init_cache", "PagedKVCache",
           "init_paged_cache",
           "RWKVCache", "MambaCache"]
