"""Token sampling for the decode loops.

Greedy decoding (``temperature <= 0``) is a pure argmax — ``torch.argmax``
returns the first maximum, as ``jnp.argmax`` does — and needs no generator.
Stochastic sampling cannot reproduce ``jax.random``'s numbers, so it is
held to the JAX package only in distribution:

* :func:`sample` (``DecodeEngine``) draws from an explicit
  ``torch.Generator``, by the exponential race ``argmax(p / q)``, q ~
  Exp(1), which is how ``torch.multinomial`` draws one sample, without
  the host-side checks that keep ``multinomial`` out of a CUDA graph (the
  engine registers the generator with the graph);
* :func:`fold_sample` (``ContinuousBatchingEngine``) is counter-based: token
  ``g`` of request ``rid`` is a Gumbel-max draw whose noise is a hash of
  ``(seed, rid, g, vocab index)``, computed on the logits' device, so a
  request's stream does not depend on chunk size, batch composition or
  slot (the JAX package folds ``(rid, g)`` into a ``jax.random`` key for
  the same contract).
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
    q = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / q, dim=-1, keepdim=True)


_MASK32 = 0xFFFFFFFF
_GOLDEN32 = 0x9E3779B9


def _mix32(x: Tensor) -> Tensor:
    """An integer hash of 32-bit values held in int64 tensors (the
    "lowbias32" shift-multiply rounds). Both multipliers are below 2**31,
    so no product leaves int64 and the result is the same on every device.
    """
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _MASK32
    return x ^ (x >> 15)


def fold_sample(logits: Tensor, seed: int, rids: Tensor, gidx: Tensor,
                temperature: float) -> Tensor:
    """Chunk-invariant stochastic sampling, one draw per row.

    logits [B, V]; ``rids`` and ``gidx`` [B] int64 (request id and emission
    index of each row) -> tokens [B] int64. The draw is
    ``argmax(logits / temperature + Gumbel noise)``, the math of
    ``jax.random.categorical``, with the uniform behind the noise a pure
    function of ``(seed, rid, g, vocab index)``.
    """
    key = _mix32(_mix32(_mix32(torch.full_like(rids, seed & _MASK32))
                        ^ rids) ^ gidx)                        # [B]
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    bits = _mix32(_mix32(key[:, None] ^ ((vocab * _GOLDEN32) & _MASK32)))
    # 23 bits: the largest u, 1 - 2**-24, is still below 1.0 in float32
    u = ((bits >> 9).float() + 0.5) * 2.0 ** -23
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() / temperature + gumbel, dim=-1)
