"""Next-token cross-entropy (``repro.train.loss``)."""
from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def next_token_loss(logits: Tensor, tokens: Tensor,
                    mask: Optional[Tensor] = None) -> Tensor:
    """logits [B, S, V] (positions 0..S-1 predict tokens 1..S); tokens
    [B, S]. Computed in f32 through logsumexp; with ``mask`` [B, S] the
    mean over the masked targets (``mask[:, 1:]``), else over all."""
    logits = logits[:, :-1, :].float()
    targets = tokens[:, 1:].long()
    lse = torch.logsumexp(logits, dim=-1)
    # the difference is taken before the trailing axis is dropped: on
    # vocab-sharded DTensor logits the gather's result is a masked partial
    # sum whose mask keeps that axis
    picked = torch.gather(logits, -1, targets[..., None])
    nll = (lse[..., None] - picked)[..., 0]
    if mask is not None:
        m = mask[:, 1:].float()
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)
