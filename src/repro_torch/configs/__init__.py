"""Architecture registry of the port. Select with ``--arch <id>``.

Every non-MoE text model of ``repro.configs`` is ported: the dense
``qwen3-0.6b``, ``qwen3-8b`` (the paper's model), ``olmo-1b`` (LayerNorm
without parameters), ``stablelm-3b`` (LayerNorm) and ``starcoder2-3b``
(LayerNorm, GELU MLP, a sliding window of 4096), the recurrent
``rwkv6-1.6b`` and the hybrid ``zamba2-7b``; both engines serve them all.
The MoE, VLM and audio ids raise ``KeyError`` until their families come
across.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ("qwen3-0.6b", "qwen3-8b", "olmo-1b", "stablelm-3b",
            "starcoder2-3b", "rwkv6-1.6b", "zamba2-7b")

#: ids the JAX package registers that the port does not have yet
NOT_YET_PORTED = (
    "musicgen-medium", "llava-next-mistral-7b", "deepseek-moe-16b",
    "granite-moe-3b-a800m",
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str):
    if arch_id in NOT_YET_PORTED:
        raise KeyError(f"arch {arch_id!r} is not yet ported to repro_torch; "
                       f"available: {ARCH_IDS}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.config()
