"""Architecture registry of the port. Select with ``--arch <id>``.

The dense ``qwen3-0.6b`` and ``qwen3-8b`` (the paper's model), the
recurrent ``rwkv6-1.6b`` and the hybrid ``zamba2-7b`` are ported; the
other ids of ``repro.configs`` raise ``KeyError`` until their model
families come across.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ("qwen3-0.6b", "qwen3-8b", "rwkv6-1.6b", "zamba2-7b")

#: ids the JAX package registers that the port does not have yet
NOT_YET_PORTED = (
    "musicgen-medium", "llava-next-mistral-7b", "deepseek-moe-16b",
    "granite-moe-3b-a800m", "stablelm-3b", "olmo-1b", "starcoder2-3b",
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
