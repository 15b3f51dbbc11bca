"""Carry the JAX package's parameters across to the port.

``from_jax_params`` takes the tree that ``repro.models.init_params`` returns,
after ``jax.device_get`` (nested dicts of numpy arrays), and returns the
port's parameter dict with the same keys and stacked layouts, so both
packages compute the same function in the parity tests: the dense,
recurrent (``rwkv``) and hybrid (``blocks`` plus ``shared_attn``) trees
alike, with every norm's leaves as they come (RMS norm's ``scale``,
LayerNorm's ``scale`` and ``bias``, OLMo's empty norms) and a GELU MLP's
``up`` and ``down`` without a ``gate``. Each leaf keeps its dtype, so the f32 leaves of a bf16 model
(RWKV6's ``w0`` and ``u``, Mamba2's ``A_log``, ``D`` and ``dt_bias``) stay
f32. It takes numpy only and imports nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .compat import DEFAULT_DEVICE, resolve_device


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)                  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":   # ml_dtypes.bfloat16: reinterpret bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def from_jax_params(tree, device=DEFAULT_DEVICE):
    """Nested dicts of numpy arrays -> nested dicts of tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_jax_params(v, dev) for k, v in tree.items()}
    return _to_tensor(tree, dev)
