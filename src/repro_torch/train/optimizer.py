"""AdamW with a global-norm clip and a warmup-cosine schedule
(``repro.train.optimizer``), in the JAX package's arithmetic: the clip
``scale = min(1, clip / (gnorm + 1e-9))``, the step counted before the
rate and the bias corrections, the update in f32 cast back to each
parameter's dtype, f32 moments, and decoupled weight decay on every leaf
with ``ndim >= 2`` (the stacked norm scales ``[L, d]`` included, as
there). Leaves are walked in JAX's flatten order (``train/tree.py``).
Each update returns new tensors; the caller's parameters and moments are
left as they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from .tree import tree_leaves, tree_unflatten

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    m: Any
    v: Any
    step: Tensor            # 0-d int32 on the parameters' device


def lr_schedule(cfg: AdamWConfig, step) -> Tensor:
    """Linear warmup then cosine decay to min_lr_ratio * lr, in f32;
    ``step`` an int or a tensor."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params: Any) -> OptState:
    leaves = tree_leaves(params)
    # zeros_like: a DTensor parameter gets moments with its placements
    zeros = [torch.zeros_like(p, dtype=torch.float32,
                              memory_format=torch.contiguous_format)
             for p in leaves]
    dev = leaves[0].device
    return OptState(m=tree_unflatten(params, zeros),
                    v=tree_unflatten(params, [z.clone() for z in zeros]),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree: Any) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def adamw_update(cfg: AdamWConfig, grads: Any, state: OptState,
                 params: Any):
    """Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1.0 - cfg.beta1 ** step.float()
    b2c = 1.0 - cfg.beta2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m_new = cfg.beta1 * m + (1 - cfg.beta1) * g
        v_new = cfg.beta2 * v + (1 - cfg.beta2) * g * g
        mh = m_new / b1c
        vh = v_new / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        p_new = (p.float() - lr * delta).to(p.dtype)
        return p_new, m_new, v_new

    out = [upd(p, g, m, v) for p, g, m, v in
           zip(tree_leaves(params), tree_leaves(grads),
               tree_leaves(state.m), tree_leaves(state.v))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, OptState(m=new_m, v=new_v, step=step), {
        "grad_norm": gnorm, "lr": lr}
