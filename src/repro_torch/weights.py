"""Carry the JAX package's parameters across to the port.

``from_jax_params`` takes the tree that ``repro.models.init_params`` returns,
after ``jax.device_get`` (nested dicts of numpy arrays), and returns the
port's parameter dict with the same keys and stacked layouts, so both
packages compute the same function in the parity tests: the dense,
MoE (a block's ``moe`` subtree: ``router``, the stacked ``w_gate`` /
``w_up`` / ``w_down`` of the routed experts and the ``shared`` experts'
``gate`` / ``up`` / ``down``), recurrent (``rwkv``) and hybrid
(``blocks`` plus ``shared_attn``) trees alike, with every norm's leaves
as they come (RMS norm's ``scale``, LayerNorm's ``scale`` and ``bias``,
OLMo's empty norms) and a GELU MLP's ``up`` and ``down`` without a
``gate``; the VLM and audio stubs' trees are the dense tree (their
frontends supply embeddings, not parameters). Each leaf keeps its dtype, so the f32 leaves of a bf16 model
(RWKV6's ``w0`` and ``u``, Mamba2's ``A_log``, ``D`` and ``dt_bias``) stay
f32. ``train_state_from_jax`` carries a ``repro.train.TrainState``
(parameters, AdamW moments ``m`` and ``v``, step) across the same way. It
takes numpy only and imports nothing of JAX.
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


def train_state_from_jax(state, device=DEFAULT_DEVICE):
    """A ``repro.train.TrainState`` after ``jax.device_get`` (its params,
    ``opt.m`` and ``opt.v`` nested dicts of numpy arrays, ``opt.step`` a
    0-d int32) -> the port's ``TrainState`` on ``device``."""
    from .train import OptState, TrainState
    dev = resolve_device(device)
    opt = state.opt
    return TrainState(
        params=from_jax_params(state.params, dev),
        opt=OptState(m=from_jax_params(opt.m, dev),
                     v=from_jax_params(opt.v, dev),
                     step=_to_tensor(np.asarray(opt.step, np.int32), dev)))
