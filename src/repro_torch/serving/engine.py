"""Decode engine: prefill + budget-enforced batched decode.

The engine runs the real model and enforces the paper's control knob
exactly: a type-k request generates EXACTLY l_k reasoning tokens, then up
to ``max_extra_tokens`` answer tokens (stopping early only on EOS after
the reasoning phase).

Two execution paths share one contract, as in ``repro.serving.engine``:

* **Chunked fast path** (default, ``use_scan=True``): the JAX package's
  fused ``lax.scan`` becomes a loop of ``chunk`` decode steps whose
  budget / EOS / alive masks and emitted tokens stay on the device; the
  host reads them back once per chunk (one device-to-host copy). The last
  chunk runs its full length (finished rows emit masked zeros).
* **Per-token reference loop** (``use_scan=False``): one decode step and
  one host sync per token. With greedy sampling both paths must produce
  the same tokens.

The engine runs every ported family (dense, RWKV6, the Mamba2 hybrid) on
the device its parameters live on: on a CUDA device every prefill
attention, wkv or SSD scan, decode attention and SwiGLU MLP goes through
the Hopper kernels. The decode cache is updated in place.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..models import decode_step, forward, sample
from ..models.config import ModelConfig


class DecodeEngine:
    def __init__(self, cfg: ModelConfig, params: dict,
                 cache_capacity: int = 512, temperature: float = 0.0,
                 chunk: int = 16, use_scan: bool = True):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["tok"].device
        self.capacity = cache_capacity
        self.temperature = temperature
        self.chunk = chunk
        self.use_scan = use_scan

    def prefill(self, prompts: np.ndarray):
        """Prompt tokens [B, S] -> (last-position logits [B, 1, V], cache)."""
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                                 device=self.device)
        out = forward(self.cfg, self.params, tokens, return_cache=True,
                      cache_capacity=self.capacity)
        return out.logits[:, -1:, :], out.cache

    def generate(self, prompts: np.ndarray, budgets: Sequence[int],
                 max_extra_tokens: int = 16,
                 eos_token: Optional[int] = None, seed: int = 0,
                 use_scan: Optional[bool] = None,
                 chunk: Optional[int] = None) -> dict:
        """prompts [B, S] int (left-padded equally), budgets per row.

        Returns {"tokens": [B, T] generated ids, "n_generated": [B],
        "n_reasoning": [B]} as numpy arrays. Row b generates exactly
        budgets[b] reasoning tokens, then up to max_extra_tokens answer
        tokens. ``seed`` seeds the ``torch.Generator`` that stochastic
        sampling draws from; greedy decoding uses none.
        """
        B, _ = prompts.shape
        use_scan = self.use_scan if use_scan is None else use_scan
        chunk = self.chunk if chunk is None else chunk
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        budgets = np.asarray(budgets, dtype=np.int32)
        if budgets.shape != (B,):
            raise ValueError(f"need one budget per prompt row ({B}), got "
                             f"shape {budgets.shape}")
        total = budgets + max_extra_tokens
        T = int(total.max())
        logits, cache = self.prefill(prompts)
        generator = None
        if self.temperature > 0.0:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        token = sample(logits, generator, self.temperature)
        if use_scan:
            out_tokens, n_gen = self._generate_chunks(
                token, cache, total, budgets, eos_token, generator, T, chunk)
        else:
            out_tokens, n_gen = self._generate_loop(
                token, cache, total, budgets, eos_token, generator, T)
        return {
            "tokens": out_tokens,
            "n_generated": n_gen,
            "n_reasoning": np.minimum(n_gen, budgets),
        }

    def _step(self, token, cache, generator):
        out = decode_step(self.cfg, self.params, token, cache)
        return sample(out.logits, generator, self.temperature), out.cache

    def _generate_chunks(self, token, cache, total, budgets, eos_token,
                         generator, T, chunk):
        """Device-resident generation: one host read per chunk."""
        B = token.shape[0]
        dev = self.device
        alive = torch.ones(B, dtype=torch.bool, device=dev)
        n_gen = torch.zeros(B, dtype=torch.int32, device=dev)
        total_d = torch.as_tensor(total, device=dev)
        budgets_d = torch.as_tensor(budgets, device=dev)
        pieces = []
        emitted = 0
        while emitted < T:
            toks = []
            for _ in range(chunk):
                toks.append(torch.where(alive, token[:, 0],
                                        torch.zeros_like(token[:, 0])))
                n_gen = n_gen + alive.to(torch.int32)
                done = n_gen >= total_d
                if eos_token is not None:
                    done = done | ((n_gen > budgets_d)
                                   & (token[:, 0] == eos_token))
                alive = alive & ~done
                token, cache = self._step(token, cache, generator)
            # the chunk's tokens and the alive mask in one device->host copy
            host = torch.cat([torch.stack(toks, dim=1),
                              alive[:, None].to(toks[0].dtype)],
                             dim=1).cpu().numpy()
            pieces.append(host[:, :chunk])
            emitted += chunk
            if not host[:, chunk].any():
                break
        out = np.concatenate(pieces, axis=1)
        if out.shape[1] < T:
            out = np.pad(out, ((0, 0), (0, T - out.shape[1])))
        return out[:, :T].astype(np.int32), n_gen.cpu().numpy()

    def _generate_loop(self, token, cache, total, budgets, eos_token,
                       generator, T):
        """Per-token reference loop (one step + host sync per token)."""
        B = token.shape[0]
        out_tokens = np.zeros((B, T), dtype=np.int32)
        alive = np.ones((B,), dtype=bool)
        n_gen = np.zeros((B,), dtype=np.int32)
        for t in range(T):
            tok = token[:, 0].cpu().numpy()
            out_tokens[:, t] = np.where(alive, tok, 0)
            n_gen += alive.astype(np.int32)
            done_budget = n_gen >= total
            if eos_token is not None:
                done_budget |= (n_gen > budgets) & (tok == eos_token)
            alive &= ~done_budget
            if not alive.any():
                break
            token, cache = self._step(token, cache, generator)
        return out_tokens, n_gen
