"""The published Zamba2 shared blocks (:class:`~.config.Zamba2Config`).

``num_mem_blocks`` weight-shared attention + MLP blocks, applied in turn
before the Mamba2 layers of ``hybrid_layer_ids``; application ``j`` uses
block ``j % num_mem_blocks`` and its own adapter and output linear
(``transformers``' ``Zamba2HybridLayer``):

    u = RMSNorm([h, x0])                  the stream and the embedding
    a = RMSNorm(Attn(u))                  q, k, v: 2 d -> heads x hd; RoPE
                                          over hd; o: heads x hd -> d
    t = GeGLU(a; gate_up + lora_a_j lora_b_j) @ linear_j

``t`` goes into the next Mamba2 layer's input (``transformer.py``); the
block adds no residual of its own. Parameters:

    shared  ln1.scale [M, 2d]; attn.wq / wk / wv [M, 2d, nh hd],
            attn.wo [M, nh hd, d]; ln2.scale [M, d];
            mlp.gate_up [M, d, 2 f], mlp.down [M, f, d]
    apps    lora_a [A, d, r], lora_b [A, r, 2 f], linear [A, d, d]

Each application keeps its own K/V: a stacked ``KVCache`` ``[A, B, C,
nkv, hd]`` (slot cache) or layer ``j`` of a ``PagedKVCache`` pool ``[A,
P + 1, bs, nkv, hd]``, which the paged continuous engine addresses through
the slot's block table as the dense stack's layers are.

Phase marks (:func:`timing_phases`): a traced serving engine on a CUDA
device installs a recorder whose ``mark(kind)`` records a timing event
at each boundary between the Mamba2 layers and the shared applications
of the captured decode step; nothing is installed otherwise.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from . import attention
from .attention import PagedKVCache
from .config import ModelConfig
from .layers import _he, apply_adapted_glu, apply_norm

Tensor = torch.Tensor

_PHASES: list = []


def init_shared(cfg: ModelConfig, gen: torch.Generator, dev) -> tuple:
    """(``shared``, ``apps``) parameter subtrees, ``_he`` scales and norm
    scales of one."""
    M, A, d, f = cfg.num_mem_blocks, cfg.n_apps, cfg.d_model, cfg.d_ff
    r, qd, kd = cfg.adapter_rank, cfg.n_heads * cfg.hd, cfg.n_kv_eff * cfg.hd
    dt = cfg.tdtype

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)
    shared = {
        "ln1": {"scale": ones(M, 2 * d)},
        "attn": {"wq": _he(gen, (M, 2 * d, qd), dt, fan_in=2 * d),
                 "wk": _he(gen, (M, 2 * d, kd), dt, fan_in=2 * d),
                 "wv": _he(gen, (M, 2 * d, kd), dt, fan_in=2 * d),
                 "wo": _he(gen, (M, qd, d), dt, fan_in=qd)},
        "ln2": {"scale": ones(M, d)},
        "mlp": {"gate_up": _he(gen, (M, d, 2 * f), dt, fan_in=d),
                "down": _he(gen, (M, f, d), dt, fan_in=f)}}
    apps = {"lora_a": _he(gen, (A, d, r), dt, fan_in=d),
            "lora_b": _he(gen, (A, r, 2 * f), dt, fan_in=max(r, 1)),
            "linear": _he(gen, (A, d, d), dt, fan_in=d)}
    return shared, apps


def _parts(cfg: ModelConfig, params: dict, j: int) -> tuple:
    """Application ``j``'s block (a view of shared block ``j % M``) and
    its adapter and linear."""
    blk = {k: {n: t[j % cfg.num_mem_blocks] for n, t in v.items()}
           for k, v in params["shared"].items()}
    return blk, {n: t[j] for n, t in params["apps"].items()}


def _out(cfg: ModelConfig, blk: dict, app: dict, a: Tensor) -> Tensor:
    """The block's tail: norm, adapted GeGLU, the application's linear."""
    a = apply_norm(cfg, blk["ln2"], a)
    t = apply_adapted_glu(cfg, blk["mlp"], app["lora_a"], app["lora_b"], a)
    return torch.matmul(t, app["linear"])


def shared_forward(cfg: ModelConfig, params: dict, j: int, h: Tensor,
                   x0: Tensor, positions: Tensor, force_ref: bool):
    """Application ``j`` over a whole sequence: h, x0 [B, S, d] ->
    (t [B, S, d], (k, v) [B, S, nkv, hd])."""
    blk, app = _parts(cfg, params, j)
    u = apply_norm(cfg, blk["ln1"], torch.cat([h, x0], dim=-1))
    a, kv = attention.attn_forward(cfg, blk["attn"], u, positions,
                                   force_ref=force_ref)
    return _out(cfg, blk, app, a), kv


def shared_decode(cfg: ModelConfig, params: dict, j: int, h: Tensor,
                  x0: Tensor, kv, force_ref: bool) -> Tensor:
    """Application ``j`` at one token: h, x0 [B, 1, d] -> t [B, 1, d],
    its K/V written in place into layer ``j`` of ``kv`` (a stacked slot
    cache or the paged pool)."""
    blk, app = _parts(cfg, params, j)
    u = apply_norm(cfg, blk["ln1"], torch.cat([h, x0], dim=-1))
    attend = (attention.attn_decode_paged if isinstance(kv, PagedKVCache)
              else attention.attn_decode_stacked)
    a = attend(cfg, blk["attn"], u, kv, kv.length, j, force_ref=force_ref)
    return _out(cfg, blk, app, a)


@contextlib.contextmanager
def timing_phases(recorder):
    """Install ``recorder`` (``mark(kind)``, kind ``"mamba"``,
    ``"shared"`` or ``"end"``) for the decode steps run inside; None
    installs nothing."""
    if recorder is None:
        yield
        return
    _PHASES.append(recorder)
    try:
        yield
    finally:
        _PHASES.pop()


def mark(kind: str) -> None:
    if _PHASES:
        _PHASES[-1].mark(kind)


class PhaseEvents:
    """The CUDA timing events of one decode step's phases, recorded in
    program order (external events, so that a captured step records them
    on every replay) and read after the step: per kind, the summed
    milliseconds between each mark and the next."""

    def __init__(self):
        self.events: list = []
        self._i = 0

    def mark(self, kind: str) -> None:
        if self._i == len(self.events):
            self.events.append((kind, torch.cuda.Event(enable_timing=True,
                                                       external=True)))
        self.events[self._i][1].record()
        self._i += 1

    def rewind(self) -> None:
        """Before the next step records: its marks reuse these events."""
        self._i = 0

    def times_ms(self) -> Optional[dict]:
        """``{kind: ms}`` of the last step recorded (its stream already
        synchronised), None before any."""
        if len(self.events) < 2:
            return None
        out: dict = {}
        for (kind, a), (_, b) in zip(self.events, self.events[1:]):
            out[kind] = out.get(kind, 0.0) + a.elapsed_time(b)
        return out
