"""Step functions run by the dry-run and the distribution phase
(``repro.launch.steps``), over the port's ``forward``, ``decode_step`` and
``make_train_step``.

``force_ref`` runs the reference math in place of the kernels; the
sharded path (a mesh installed, DTensor parameters) must pass it, since no
kernel is sharded and a kernel wrapper handed a DTensor raises. The train
step always differentiates the reference math (``train/trainer.py``).
"""
from __future__ import annotations

from typing import Optional

from ..models import decode_step, forward
from ..models.config import ModelConfig
from ..train.optimizer import AdamWConfig
from ..train.trainer import make_train_step


def make_prefill_step(cfg: ModelConfig, force_ref: bool = False):
    def prefill_step(params, tokens, prefix_embeds=None):
        capacity = tokens.shape[1] + (cfg.n_prefix_embeds or 0)
        out = forward(cfg, params, tokens, prefix_embeds=prefix_embeds,
                      return_cache=True, cache_capacity=capacity,
                      force_ref=force_ref, last_logits_only=True)
        # serving returns only the next-token logits; the full [B,S,V]
        # logits tensor is never computed
        return out.logits, out.cache
    return prefill_step


def make_serve_step(cfg: ModelConfig, force_ref: bool = False):
    def serve_step(params, token, cache):
        out = decode_step(cfg, params, token, cache, force_ref=force_ref)
        return out.logits, out.cache
    return serve_step


def make_train_step_fn(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                       microbatch: Optional[int] = None):
    opt_cfg = opt_cfg or AdamWConfig()
    return make_train_step(cfg, opt_cfg, microbatch=microbatch)
