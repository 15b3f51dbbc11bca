"""Architecture registry of the port. Select with ``--arch <id>``.

Every model of ``repro.configs`` is ported: the dense ``qwen3-0.6b``,
``qwen3-8b`` (the paper's model), ``olmo-1b`` (LayerNorm without
parameters), ``stablelm-3b`` (LayerNorm) and ``starcoder2-3b``
(LayerNorm, GELU MLP, a sliding window of 4096), the mixtures of experts
``deepseek-moe-16b`` (64 routed experts top-6 plus 2 shared) and
``granite-moe-3b-a800m`` (40 experts top-8), the recurrent
``rwkv6-1.6b``, the hybrid ``zamba2-7b``, and the stubbed-frontend
``llava-next-mistral-7b`` (VLM, 1152 image-patch embeddings) and
``musicgen-medium`` (audio, 64 conditioning frames, LayerNorm, GELU
MLP); both engines serve them all (the VLM and audio ids text-only on
the continuous engine and the server, as in the JAX package).

``PORT_IDS`` are the port's own, with no JAX counterpart:
``zamba2-7b-instruct``, the hybrid as Zyphra publishes it (two
alternating shared blocks over [h, embedding], grouped Mamba2), which
the paged continuous engine serves.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ("qwen3-0.6b", "qwen3-8b", "olmo-1b", "stablelm-3b",
            "starcoder2-3b", "deepseek-moe-16b", "granite-moe-3b-a800m",
            "rwkv6-1.6b", "zamba2-7b", "llava-next-mistral-7b",
            "musicgen-medium")

#: ids the JAX package registers that the port does not have yet: none
NOT_YET_PORTED: tuple = ()
#: the port's own ids, which the JAX package does not register
PORT_IDS = ("zamba2-7b-instruct",)

_MODULES = {a: a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS + PORT_IDS}


def get_config(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: "
                       f"{ARCH_IDS + PORT_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.config()


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
