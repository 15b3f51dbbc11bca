"""Training step (``repro.train.trainer``).

The loss runs the model's reference math (``forward(..., force_ref=True)``),
plain PyTorch that autograd differentiates. The JAX package trains the
same way: its ``ModelConfig.use_kernels`` defaults to off, its training
driver never sets it, and none of its Pallas kernels has a VJP. The
port's Hopper kernels are forward-only as well (their outputs carry no
``grad_fn``), and a kernel wrapper refuses an input that requires grad
(``kernels/_cuda.refuse_grad``), so no training step can reach one and
silently drop the gradient of the parameters before it.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..compat import DEFAULT_DEVICE, is_dtensor
from ..models import forward
from ..models.config import ModelConfig
from .loss import next_token_loss
from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state
from .tree import tree_leaves, tree_unflatten

Tensor = torch.Tensor


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatch: Optional[int] = None):
    """Returns train_step(state, batch) -> (state, metrics).

    batch = {"tokens": [B, S+1] int, optional "prefix_embeds": [B, P, d]}
    (numpy arrays or tensors). ``microbatch`` accumulates gradients over
    the first ``B // microbatch`` chunks of ``microbatch`` rows (the
    remainder is dropped, as in the JAX package), summed in f32 and
    divided by the chunk count. The metrics are ``loss`` (the
    cross-entropy), ``total_loss`` (plus the MoE aux loss), ``grad_norm``
    and ``lr``, 0-d tensors. The returned state is new; the argument's
    tensors are not modified.
    """

    def loss_fn(params, tokens, prefix_embeds):
        """tokens [B, S+1]; the model sees tokens[:, :-1] (plus any prefix
        embeds, whose logits are discarded) and logits[t] scores
        tokens[t+1]."""
        out = forward(cfg, params, tokens[:, :-1],
                      prefix_embeds=prefix_embeds, force_ref=True)
        S = tokens.shape[1] - 1
        logits = out.logits[:, -S:, :]
        # pad one dummy position so next_token_loss's shift lines up
        ce = next_token_loss(torch.cat([logits, logits[:, -1:]], dim=1),
                             tokens)
        return ce + out.aux_loss.float(), ce

    def grads_of(params, tokens, prefix_embeds):
        leaves = [p.detach().requires_grad_(True) for p in
                  tree_leaves(params)]
        with torch.enable_grad():
            total, ce = loss_fn(tree_unflatten(params, leaves), tokens,
                                prefix_embeds)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return total.detach(), ce.detach(), grads

    def train_step(state: TrainState, batch: dict):
        dev = tree_leaves(state.params)[0].device
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        pe = batch.get("prefix_embeds")
        if pe is not None:
            pe = torch.as_tensor(pe, device=dev)
        if microbatch is None or microbatch >= tokens.shape[0]:
            total, ce, grads = grads_of(state.params, tokens, pe)
        else:
            nmb = tokens.shape[0] // microbatch
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in tree_leaves(state.params)]
            total = torch.zeros((), device=dev)
            ce = torch.zeros((), device=dev)
            for i in range(nmb):
                rows = slice(i * microbatch, (i + 1) * microbatch)
                t, c, g = grads_of(state.params, tokens[rows],
                                   None if pe is None else pe[rows])
                grads = [a + b for a, b in zip(grads, g)]
                total, ce = total + t, ce + c
            grads = [g / nmb for g in grads]
            total, ce = total / nmb, ce / nmb
        new_params, new_opt, metrics = adamw_update(
            opt_cfg, tree_unflatten(state.params, grads), state.opt,
            state.params)
        # sharded: the new state in the old state's placements (DTensor
        # picks each update's output layout by itself)
        new_params = _placed_like(new_params, state.params)
        new_opt = new_opt._replace(m=_placed_like(new_opt.m, state.opt.m),
                                   v=_placed_like(new_opt.v, state.opt.v))
        metrics = dict(metrics, loss=ce, total_loss=total)
        return TrainState(params=new_params, opt=new_opt), metrics

    return train_step


def _placed_like(tree: Any, like: Any) -> Any:
    """``tree``'s DTensor leaves redistributed to the placements of
    ``like``'s (plain leaves as they are)."""
    return tree_unflatten(like, [
        new.redistribute(old.device_mesh, old.placements)
        if is_dtensor(old) and new.placements != old.placements else new
        for new, old in zip(tree_leaves(tree), tree_leaves(like))])


def init_train_state(cfg: ModelConfig, seed: int = 0,
                     device=DEFAULT_DEVICE) -> TrainState:
    """Random parameters (``models.init_params``) and zeroed moments."""
    from ..models import init_params
    params = init_params(cfg, seed=seed, device=device)
    return TrainState(params=params, opt=init_opt_state(params))
