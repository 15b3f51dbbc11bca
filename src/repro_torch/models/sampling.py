"""Token sampling for the decode loop.

Greedy decoding (``temperature <= 0``) is a pure argmax — ``torch.argmax``
returns the first maximum, as ``jnp.argmax`` does — and needs no generator.
Stochastic sampling draws from an explicit ``torch.Generator``; it cannot
reproduce ``jax.random``'s numbers, so it is held to the JAX package only
in distribution.
"""
from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def sample(logits: Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0) -> Tensor:
    """logits [B, 1, V] -> tokens [B, 1] int64 on the logits' device."""
    logits = logits[:, -1, :].float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)[:, None]
    if generator is None:
        raise ValueError("stochastic sampling (temperature > 0) needs a "
                         "generator")
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)
