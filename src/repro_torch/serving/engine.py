"""Decode engine: prefill + budget-enforced batched decode.

The engine runs the real model and enforces the paper's control knob
exactly: a type-k request generates EXACTLY l_k reasoning tokens, then up
to ``max_extra_tokens`` answer tokens (stopping early only on EOS after
the reasoning phase).

Two execution paths share one contract, as in ``repro.serving.engine``:

* **Chunked fast path** (default, ``use_scan=True``): the JAX package
  compiles its fused ``lax.scan`` chunk once and dispatches it as one
  executable; here one decode step over static device buffers (the
  token, the budget / EOS / alive masks, the emission counts, the cache
  and the chunk's ``[B, chunk]`` tokens, written at a device-side step
  index) is captured as a CUDA graph once per ``(B, chunk)`` shape, on
  the engine's capacity, and replayed ``chunk`` times a chunk. Every
  budget, prompt length and request reuses that capture (counted by
  ``obs.graph_hooks`` under ``"engine.chunk"``). The host reads the
  chunk's tokens, the alive mask and the counts back once per chunk
  (``graph_hooks.to_host``). The last chunk runs its full length
  (finished rows emit masked zeros). On a CPU device the same step runs
  eagerly; on CUDA a capture that fails raises.
* **Per-token reference loop** (``use_scan=False``): one eager decode
  step and one host sync per token. With greedy sampling both paths must
  produce the same tokens.

The engine runs every ported family (dense, RWKV6, the Mamba2 hybrid) on
the device its parameters live on: on a CUDA device every prefill
attention, wkv or SSD scan, decode attention and SwiGLU MLP goes through
the Hopper kernels (a GELU MLP is PyTorch's matmuls, as in the JAX
package), and the decode kernels run inside the captured step. A
sliding-window model keeps a ring of ``min(cache_capacity, window)``
slots, which a prompt longer than the ring overflows into.
Prefill stays eager (its shapes follow the prompt). The decode cache is
updated in place; an int8 KV cache (``kv_cache_dtype="int8"``) is a
static buffer like any other, its scales copied in beside its codes.

With a ``tracer`` (``obs.trace.Tracer``) the engine records wall spans
``engine.prefill`` and ``engine.decode_chunk``, as the JAX package's does.
A chunk's span ends at its host read; the prefill span ends at a device
synchronisation, made only when a tracer is present, so the untraced
path is unchanged.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Optional, Sequence

import numpy as np
import torch

from ..models import decode_step, forward, sample
from ..models.config import ModelConfig
from ..obs import graph_hooks

#: the EOS buffer's value when no EOS token is given: no token id matches
_NO_EOS = -1


class DecodeEngine:
    def __init__(self, cfg: ModelConfig, params: dict,
                 cache_capacity: int = 512, temperature: float = 0.0,
                 chunk: int = 16, use_scan: bool = True, tracer=None):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["tok"].device
        self.capacity = cache_capacity
        self.temperature = temperature
        self.chunk = chunk
        self.use_scan = use_scan
        # wall spans around prefill and decode chunks when a Tracer is
        # attached; one `is not None` check per dispatch otherwise
        self.tracer = tracer
        # the one generator stochastic sampling draws from, reseeded per
        # call and registered with every captured step
        self._generator = (torch.Generator(device=self.device)
                           if temperature > 0.0 else None)
        self._graphs = graph_hooks.GraphCache(
            "engine.chunk", self.device,
            () if self._generator is None else (self._generator,))
        self._static: dict = {}       # (B, chunk) -> the step's buffers

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
        B, S = prompts.shape
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
        if self.tracer is not None:
            with self.tracer.span("engine.prefill", cat="engine",
                                  args={"B": B, "S": S}):
                logits, cache = self.prefill(prompts)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        else:
            logits, cache = self.prefill(prompts)
        generator = self._generator
        if generator is not None:
            generator.manual_seed(seed)
        token = sample(logits, generator, self.temperature)
        if use_scan:
            out_tokens, n_gen = self._generate_chunks(
                token, cache, total, budgets, eos_token, T, chunk)
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

    def _prepare(self, token, cache, total, budgets, eos_token,
                 chunk: int):
        """The static buffers of the ``(B, chunk)`` step, loaded with this
        call's first token, cache and budgets (host-to-device copies, all
        before any replay), and the step over them. The first call for a
        shape adopts its prefill cache as the static one."""
        B = token.shape[0]
        key = (B, chunk)
        st = self._static.get(key)
        if st is None:
            dev = self.device
            st = self._static[key] = {
                "token": torch.empty_like(token), "cache": cache,
                "alive": torch.empty(B, dtype=torch.bool, device=dev),
                "n_gen": torch.empty(B, dtype=torch.int32, device=dev),
                "total": torch.empty(B, dtype=torch.int32, device=dev),
                "budgets": torch.empty(B, dtype=torch.int32, device=dev),
                "eos": torch.empty((), dtype=torch.long, device=dev),
                "out": torch.empty((B, chunk), dtype=torch.long,
                                   device=dev),
                "idx": torch.empty((), dtype=torch.long, device=dev)}
        else:
            _copy_tree(st["cache"], cache)
        st["token"].copy_(token)
        st["alive"].fill_(True)
        st["n_gen"].zero_()
        st["total"].copy_(torch.from_numpy(total.astype(np.int32)))
        st["budgets"].copy_(torch.from_numpy(budgets))
        st["eos"].fill_(_NO_EOS if eos_token is None else eos_token)
        st["idx"].zero_()

        def step():
            """Emit the current token (masked for finished rows), update
            the counts and masks, decode the next token: the body of the
            JAX package's scan, in place on the static buffers."""
            tok = st["token"][:, 0]
            alive = st["alive"]
            st["out"].index_copy_(
                1, st["idx"].reshape(1),
                torch.where(alive, tok, torch.zeros_like(tok))[:, None])
            st["n_gen"].add_(alive.to(torch.int32))
            done = (st["n_gen"] >= st["total"]) | (
                (st["n_gen"] > st["budgets"]) & (tok == st["eos"]))
            alive.logical_and_(~done)
            out = decode_step(self.cfg, self.params, st["token"], st["cache"])
            st["token"].copy_(sample(out.logits, self._generator,
                                     self.temperature))
            st["idx"].add_(1).remainder_(chunk)
        return key, st, step

    def _generate_chunks(self, token, cache, total, budgets, eos_token,
                         T, chunk):
        """Replayed generation: ``chunk`` replays of the captured step,
        then one host read per chunk."""
        key, st, step = self._prepare(token, cache, total, budgets,
                                      eos_token, chunk)
        pieces = []
        emitted = 0
        n_gen = np.zeros(token.shape[0], dtype=np.int32)
        tracer = self.tracer
        while emitted < T:
            ctx = (tracer.span("engine.decode_chunk", cat="engine",
                               args={"chunk": chunk, "emitted": emitted})
                   if tracer is not None else nullcontext())
            with ctx:
                for _ in range(chunk):
                    self._graphs.run(key, step)
                # the chunk's tokens, the alive mask and the counts in one
                # device->host copy, which ends the span
                host = graph_hooks.to_host(torch.cat(
                    [st["out"], st["alive"][:, None].long(),
                     st["n_gen"][:, None].long()], dim=1), "engine.chunk")
            pieces.append(host[:, :chunk])
            n_gen = host[:, chunk + 1].astype(np.int32)
            emitted += chunk
            if not host[:, chunk].any():
                break
        out = np.concatenate(pieces, axis=1)
        if out.shape[1] < T:
            out = np.pad(out, ((0, 0), (0, T - out.shape[1])))
        return out[:, :T].astype(np.int32), n_gen

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


def _copy_tree(dst, src) -> None:
    """Copy every tensor leaf of a decode cache (a dict of cache tuples:
    an int8 cache's codes and scales alike) into the same leaf of ``dst``,
    in place."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_tree(dst[k], src[k])
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _copy_tree(d, s)
    elif isinstance(dst, torch.Tensor):
        dst.copy_(src)
