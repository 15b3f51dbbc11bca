"""Continuous batching: requests join and leave the decode batch in flight.

The port of ``repro.serving.continuous``. A fixed pool of ``max_slots``
decode rows, each holding an independent request at its own cache
position:

* **batched admission**: up to k queued requests prefill in ONE
  right-padded B=k forward (``admit_many``), and all k rows are inserted
  into the engine cache by one indexed write over a slot-index vector,
* one shared decode step advances every active slot, either per token
  (``step``, the reference) or ``chunk`` steps at a time (``step_chunk``):
  the JAX package's fused ``lax.scan`` becomes one decode step over
  static buffers sized ``max_slots`` (the slots' tokens, request ids and
  emission indices, the cache, the chunk's ``[chunk, max_slots]`` tokens
  written at a device-side step index), captured as a CUDA graph once per
  ``chunk`` and replayed ``chunk`` times (``obs.graph_hooks`` labels
  ``"continuous.slot"`` and ``"continuous.paged"``); the host copies the
  slots' state into those buffers before the replays and reads the
  chunk's tokens back once (on a CPU device the same step runs eagerly),
* strict per-slot budget enforcement (the paper's control knob): a slot
  retires when ``budget + max_extra`` tokens are out.

Admission (``_admit_group``, a prefill whose shape follows the prompts)
stays eager, as do the block-table refresh and the host-to-device copies
of each chunk's inputs: all of them run between replays.

Paged mode (``paged=True``): the KV cache is a shared pool of fixed-size
blocks (:class:`~..models.attention.PagedKVCache`) and admission is gated
by tokens, not rows. A request is admitted while its worst-case need
(``prompt_len + budget + max_extra - 1`` tokens) fits the unreserved pool
(:class:`BlockAllocator` reservation) and a row is free. Physical blocks
are allocated lazily at chunk boundaries and freed when the slot retires.
The block table is authoritative on the host and copied to the device, as
data, only when it changed, once per chunk boundary; the decode loop reads
no position back. Exhaustion is back-pressure: ``admit_many`` returns
False for requests that do not fit and the caller offers them again.

Stochastic sampling (``temperature > 0``) is chunk-invariant: token ``g``
of request ``rid`` is drawn by :func:`~..models.sampling.fold_sample`, a
pure function of ``(seed, rid, g)``, so ``step`` and ``step_chunk`` (any
chunk, any admission order, paged or slot) give the same streams.

Correctness contract (as the JAX package's): with greedy sampling a
request served in a rolling batch produces exactly the tokens it would
produce alone, and the paged path matches the slot path token for token,
as the tests hold it on the CPU in f32, back-pressured or not. In bf16
the match needs equal admission groups: a back-pressured paged mode
prefills other groups than the slot mode, at other padded shapes and so
in other summation orders, and a greedy argmax between near-equal logits
can go the other way.

The KV cache may be int8 (``kv_cache_dtype="int8"``), on the slot
cache and on the paged pool: admission quantises the prefilled rows and
inserts their codes and scales together, and the decode step attends
over the dequantised cache with the slot decode kernel, paged or not.

Hooks, as the JAX package's: a ``tracer`` (``obs.trace.Tracer``) records
wall spans ``continuous.admit`` (rows, padded length) and
``continuous.decode_chunk`` (chunk, occupancy, tokens in use), each
ending at its host read. The port adds phase spans on the wall clock:

* ``continuous.admit.read`` inside ``continuous.admit``, its last part:
  the blocking read of the first tokens, i.e. the device's tail after
  the host has enqueued the prefill (on the paged pool no host-to-device
  copy follows the prefill, so nothing in the enqueueing waits for it);
* ``continuous.chunk.prepare`` before ``continuous.decode_chunk`` (block
  growth, the table's and the inputs' host-to-device copies) and
  ``continuous.chunk.retire`` after it (the tokens' bookkeeping,
  retirements and block frees);
* ``continuous.admit.stats`` and ``continuous.chunk.stats`` right after
  their parents, which they leave as the JAX engine's: the tracer's own
  reads, whose results are their args. On a MoE backbone
  ``continuous.admit.stats`` holds ``pairs``, ``kept`` (under the
  capacity) and ``experts_hit`` ((layer, expert) pairs with a pair
  routed), and ``continuous.chunk.stats`` ``pairs`` (``max_slots`` x k x
  layers x steps, empty rows' included) and ``experts_hit`` over the
  (step, layer, expert) triples. On a CUDA device a chunk of two or more
  steps that replays its graph records one CUDA event before the first
  replay and one after each, and ``continuous.chunk.stats`` gives
  ``first_step_ms`` (first event to second: the first step and the
  device's wait for its launch) and ``step_ms`` (second to last over
  ``chunk - 1``: a step fed back to back) on the device's clock.

The MoE counts come from ``models.moe.count_routing``, installed around
the prefill and inside the captured step only when the engine holds a
tracer; without one no event, count buffer, stats span or extra read
exists, and the captured step is the same.

The published Zamba2 hybrid (``cfg.published_hybrid``) keeps two kinds of
state side by side: every layer's Mamba2 state in per-slot rows, and its
shared applications' K/V in the paged pool (or, slot mode, in per-slot
rows of the cache's capacity). Traced, its admissions add
``continuous.admit.insert`` (inside ``continuous.admit``, around the
insert of both kinds of state), and ``continuous.chunk.stats`` gives
``kv_blocks`` (pool blocks in use; paged only) and ``state_rows`` (the
rows whose recurrent state a step updates: all ``max_slots``); on a CUDA
device the captured step records external timing events at each switch
between the Mamba2 layers and the shared applications
(``models.zamba2.timing_phases``), and a replayed chunk's stats give its
last step's ``mamba_ms`` and ``shared_ms``.

``faults`` (``faults.FaultInjector``) gets ``on_decode_step(self)`` at
the top of every ``step`` and ``step_chunk``, even while idle, so a
fault such as ``PoolPressure`` reserves and returns pool blocks on the
host between replays. An external
reservation only shrinks what admission sees (back-pressure); the device
block table is copied only when a slot's blocks changed.

Padding contract (as the JAX package's): right-padded batched admission
is exact for the full-attention dense backbone (causal masking leaves the
last real token's logits unchanged, and decode overwrites a pad's K/V
before the per-row mask exposes it), so there every admission is one
group. The MoE backbone pads as the dense one does, unless it dispatches
by capacity: then the rows of one prefill (pads included) compete for
the experts' capacity slots, and a token kept when its prompt is served
alone could be dropped in a batch, so its admissions prefill one request
at a time (``_batch_rows``), as the JAX package's do. Recurrent (RWKV6)
and hybrid (Mamba2 + shared attention) rows, and sliding-window rows,
fold pads into carried state or into a ring, so
their admissions group by equal prompt length, in the JAX engine's order,
with no pads: one prefill per group (the scan kernels at B = the group's
rows). The insert overwrites every state leaf of each new row (the conv
tails, shift vectors and wkv / SSD states, the shared block's K/V and its
per-row position), so a refilled slot keeps nothing of the request it
held. The recurrent states carry no position, and the decode step copies
them in place, so one captured step serves every admission. These
backbones refuse the paged pool (``ValueError``), as the JAX package's
do; the dense and MoE backbones take it, and so does the published
Zamba2 hybrid, whose paged pool holds its shared applications' K/V while
its Mamba2 states stay in rows (``models.init_paged_decode_cache``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import (decode_step, fold_sample, forward, init_decode_cache,
                      init_paged_decode_cache)
from ..models import moe, zamba2
from ..models.attention import (KVCache, PagedKVCache, QuantKVCache,
                                kv_fields, seed_slots)
from ..models.config import ModelConfig
from ..obs import graph_hooks
from ..obs.trace import NULL_TRACER


@dataclasses.dataclass
class Slot:
    rid: int
    budget: int
    max_extra: int
    generated: int = 0
    tokens: list = dataclasses.field(default_factory=list)
    last_token: int = 0
    prompt_len: int = 0

    @property
    def cache_len(self) -> int:
        """Tokens currently held in KV for this slot (prompt + decode
        writes; the prefill's first emitted token is not yet written)."""
        return self.prompt_len + max(self.generated - 1, 0)


class BlockAllocator:
    """LIFO free list + reservation accounting over the paged KV pool.

    Reservation happens at admission (worst-case blocks for the request's
    prompt + budget + answer), physical allocation lazily at chunk
    boundaries. Because the sum of reservations never exceeds the pool, a
    lazy ``alloc`` can never fail mid-flight: exhaustion only surfaces as
    an admission refusal, which queues the request.
    """

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free = list(range(n_blocks - 1, -1, -1))  # pop() -> block 0 first
        self.reserved = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_allocated(self) -> int:
        return self.n_blocks - len(self._free)

    def can_reserve(self, n: int) -> bool:
        return self.reserved + n <= self.n_blocks

    def reserve(self, n: int) -> bool:
        if not self.can_reserve(n):
            return False
        self.reserved += n
        return True

    def release(self, n: int) -> None:
        if n > self.reserved:
            raise AssertionError(f"releasing {n} blocks of a {self.reserved}"
                                 "-block reservation")
        self.reserved -= n

    def alloc(self, n: int) -> list:
        if n > len(self._free):
            raise AssertionError("allocation beyond reservation")
        return [self._free.pop() for _ in range(n)]

    def free(self, blocks) -> None:
        self._free.extend(blocks)
        if len(self._free) > self.n_blocks:
            raise AssertionError("more free blocks than the pool holds")

    def check_balance(self, in_use: Optional[int] = None) -> bool:
        """Audit the pool accounting; raises ``AssertionError`` on a
        violation: a duplicate or out-of-range free block, ``free +
        in_use != n_blocks`` (``in_use`` the caller's independent count of
        blocks held), or a reservation outside ``[0, n_blocks]``."""
        free = self._free
        if len(set(free)) != len(free):
            raise AssertionError("duplicate block on the free list")
        if free and not all(0 <= b < self.n_blocks for b in free):
            raise AssertionError("out-of-range block on the free list")
        if not 0 <= self.reserved <= self.n_blocks:
            raise AssertionError(
                f"reservation accounting broken: {self.reserved} not in "
                f"[0, {self.n_blocks}]")
        if in_use is not None and len(free) + int(in_use) != self.n_blocks:
            raise AssertionError(
                f"block leak: {len(free)} free + {in_use} in use "
                f"!= {self.n_blocks} total")
        return True


class ContinuousBatchingEngine:
    #: recurrent state one admission prefill of the published Zamba2
    #: hybrid may stack for its rows (``_batch_rows``)
    ADMIT_STATE_BYTES = 1 << 30

    def __init__(self, cfg: ModelConfig, params: dict, max_slots: int = 4,
                 capacity: int = 512, chunk: int = 8, paged: bool = False,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0, tracer=None,
                 faults=None):
        cfg.validate()
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["tok"].device
        self.max_slots = max_slots
        self.chunk = chunk
        self.temperature = float(temperature)
        self.seed = int(seed)
        # wall spans around admission and decode chunks (obs.trace); one
        # `is not None` check per dispatch when absent
        self.tracer = tracer
        # fault injectors (faults.FaultInjector): on_decode_step fires at
        # every step / chunk boundary, even while idle, so a pool-pressure
        # reservation cannot outlive its hold window
        self.faults = faults
        self.paged = paged
        if paged:
            if not self._can_page():
                raise ValueError(
                    "paged KV requires a full-attention backbone (attn or "
                    "moe, no sliding window, no shared attention) or the "
                    "published Zamba2 hybrid")
            self.block_size = block_size
            self.n_bt = max(1, math.ceil(capacity / block_size))
            self.capacity = self.n_bt * block_size
            # default pool = the slot path's aggregate KV memory
            self.n_blocks = (max_slots * self.n_bt if n_blocks is None
                             else n_blocks)
            self.allocator = BlockAllocator(self.n_blocks)
            self._slot_blocks = [[] for _ in range(max_slots)]
            self._slot_reserved = [0] * max_slots
            self._tables_host = np.full((max_slots, self.n_bt),
                                        self.n_blocks, np.int32)
            self._tables_dirty = False
            self.cache = init_paged_decode_cache(
                cfg, max_slots, self.n_blocks, block_size, self.n_bt,
                self.device)
        else:
            self.block_size = None
            self.n_blocks = None
            self.allocator = None
            self.capacity = capacity
            # every KV cache (the dense stack's, the hybrid's shared
            # block's) at one position per slot
            self.cache = {
                part: (c._replace(length=torch.zeros(
                    max_slots, dtype=torch.int32, device=self.device))
                       if isinstance(c, (KVCache, QuantKVCache)) else c)
                for part, c in init_decode_cache(cfg, max_slots, capacity,
                                                 self.device).items()}
        self.slots: list = [None] * max_slots
        self._graphs = graph_hooks.GraphCache(
            "continuous.paged" if paged else "continuous.slot", self.device)
        # the captured step's per-slot inputs (rows: token, request id,
        # emission index), and per chunk its outputs
        self._inputs = torch.zeros((3, max_slots), dtype=torch.long,
                                   device=self.device)
        self._outs: dict = {}
        # traced only: per chunk its CUDA events and the routing counts of
        # its captured step, and the prefill's routing counts
        self._events: dict = {}
        self._routing: dict = {}
        self._prefill_counts = None
        self._phases = (zamba2.PhaseEvents()
                        if tracer is not None and cfg.published_hybrid
                        and self.device.type == "cuda" else None)

    # ------------------------------------------------------------ internals
    def _can_page(self) -> bool:
        """Paged decode covers the full-attention backbones (dense and
        MoE): K/V per position, blocks addressed by position; and the
        published Zamba2 hybrid, whose applications' K/V page while its
        Mamba2 states stay in rows. Ring buffers (sliding window), the
        recurrent stack and the JAX package's hybrid stay in slots."""
        return ((self.cfg.has_attn_layers or self.cfg.published_hybrid)
                and self.cfg.sliding_window is None)

    @property
    def _pool(self) -> PagedKVCache:
        """The paged pool of the cache (paged mode)."""
        return self.cache["shared" if self.cfg.published_hybrid
                          else "layers"]

    def _batch_rows(self) -> int:
        """How many requests one admission prefill may batch exactly:
        one for capacity-dispatch MoE, whose rows (and pads) compete for
        the experts' capacity slots, so that a request's tokens are those
        it gets served alone; for the published Zamba2 hybrid as many as
        fit ``ADMIT_STATE_BYTES`` of recurrent state, which the prefill
        stacks for its rows beside the engine's own (full size: ~150 MB a
        row, so 7 rows); else every slot."""
        if (self.cfg.backbone_kind == "moe"
                and self.cfg.moe.impl == "capacity"):
            return 1
        if self.cfg.published_hybrid:
            row = sum(t.numel() * t.element_size()
                      for t in self.cache["mamba"]
                      if isinstance(t, torch.Tensor)) // self.max_slots
            return max(1, min(self.max_slots, self.ADMIT_STATE_BYTES // row))
        return self.max_slots

    def _can_pad_batch(self) -> bool:
        """Right-padded ragged prefill is exact only where no state flows
        forward past the pads (pure attention, no window) and rows do not
        couple through shared capacity buffers."""
        return (self.cfg.has_attn_layers and self._batch_rows() > 1
                and not self.cfg.has_shared_attn
                and self.cfg.sliding_window is None)

    def _chunk_step(self, chunk: int):
        """One decode step of every slot over the static buffers: the
        next tokens land in row ``idx`` of the chunk's ``[chunk, slots]``
        output, the step index wraps at ``chunk``, and every position
        advances in place."""
        if chunk not in self._outs:
            self._outs[chunk] = (
                torch.zeros((chunk, self.max_slots), dtype=torch.long,
                            device=self.device),
                torch.zeros((), dtype=torch.long, device=self.device))
            if self.tracer is not None and self._counts_routing():
                self._routing[chunk] = moe.RoutingCounts(
                    self.cfg.n_layers, self.cfg.moe.n_experts, self.device,
                    steps=chunk, step=self._outs[chunk][1])
        out, idx = self._outs[chunk]
        token, rids, gidx = self._inputs
        routing = self._routing.get(chunk)

        phases = self._phases

        def step():
            if phases is not None:
                phases.rewind()
            with moe.count_routing(routing), zamba2.timing_phases(phases):
                res = decode_step(self.cfg, self.params, token[:, None],
                                  self.cache)
            nxt = self._next_tokens(res.logits[:, 0], rids, gidx)
            token.copy_(nxt)
            out.index_copy_(0, idx.reshape(1), nxt[None])
            gidx.add_(1)
            idx.add_(1).remainder_(chunk)
        return step

    def _counts_routing(self) -> bool:
        """Whether the backbone's MoE layers give group sizes to count
        (every dispatch but the dense oracle)."""
        return (self.cfg.backbone_kind == "moe"
                and self.cfg.moe.impl != "dense")

    def _rows(self, values, dtype=torch.int64) -> torch.Tensor:
        """A per-slot host list as a device tensor (host-to-device only)."""
        return torch.tensor(values, dtype=dtype, device=self.device)

    def _next_tokens(self, logits: torch.Tensor, rids: torch.Tensor,
                     gidx: torch.Tensor) -> torch.Tensor:
        """logits [B, V] -> tokens [B]: greedy, or the chunk-invariant
        seeded draw of token ``gidx`` of request ``rids``."""
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        return fold_sample(logits, self.seed, rids, gidx, self.temperature)

    def _insert(self, seeds: dict, slot_idx, lengths: torch.Tensor) -> None:
        """Write k prefilled rows (``forward``'s cache seeds, batch k) into
        the cache at ``slot_idx``, every state leaf of each row: K/V
        through :meth:`_insert_kv` (slot cache) or :meth:`_insert_paged`
        (the pool), a recurrent state's leaves (stacked on the layer axis,
        the hybrid's grouped stack on two) whole. ``lengths`` [k] are the
        rows' true prompt lengths."""
        for part, dst in self.cache.items():
            if dst is None:
                continue
            src = seeds[part]
            if isinstance(dst, PagedKVCache):
                self._insert_paged(dst, *src, slot_idx, lengths)
                continue
            if isinstance(dst, (KVCache, QuantKVCache)):
                self._insert_kv(dst, *src, slot_idx, lengths)
                continue
            idx = (slice(None),) * (2 if part == "grouped" else 1) \
                + (slot_idx,)
            for d, s in zip(dst, src):
                if isinstance(d, torch.Tensor):
                    d[idx] = s

    def _insert_kv(self, kv, k: torch.Tensor, v: torch.Tensor, slot_idx,
                   lengths: torch.Tensor) -> None:
        """Write k prefilled rows of K/V (``[L, k, S, nkv, hd]``) into the
        stacked cache at ``slot_idx``: the positions ``seed_slots`` keeps
        at their slots (a ring's last C at ``p % C``), the rest of each row
        as the JAX package's capacity-padded rows are (zeros; an int8
        cache's scales there are those of quantised zeros, 1e-8)."""
        S = k.shape[2]
        kept, slots = (t.to(self.device)
                       for t in seed_slots(self.cfg, S, kv.capacity))
        for name, rows in kv_fields(k[:, :, kept], v[:, :, kept],
                                    isinstance(kv, QuantKVCache)):
            buf = getattr(kv, name)
            buf[:, slot_idx[:, None], slots[None]] = rows
            buf[:, slot_idx, S:] = 1e-8 if name.endswith("scale") else 0
        kv.length[slot_idx] = lengths

    def _insert_paged(self, pc: PagedKVCache, k: torch.Tensor,
                      v: torch.Tensor, slot_idx,
                      lengths: torch.Tensor) -> None:
        """Scatter k prefilled rows into the paged pool ``pc`` (an int8
        pool: their codes and, beside them, their scales). Logical
        position p of row r lands at ``pool[:, table[slot, p // bs], p %
        bs]``; pad positions (p >= lengths[r]) land on the trash block."""
        P, bs = pc.n_blocks, pc.block_size
        S = k.shape[2]
        ppos = torch.arange(S, device=self.device)
        bidx = (ppos // bs).clamp(max=self.n_bt - 1)
        rows_bt = pc.block_tables[slot_idx]                      # [k, n_bt]
        blk = torch.where(ppos[None] < lengths[:, None],
                          rows_bt[:, bidx], P)                   # [k, S]
        off = (ppos % bs).expand_as(blk)
        for name, rows in kv_fields(k, v, self.cfg.kv_cache_dtype == "int8"):
            getattr(pc, name)[:, blk, off] = rows
        pc.length[slot_idx] = lengths

    # -------------------------------------------------- paged block plumbing
    def _reserve_tokens(self, prompt_len: int, budget: int,
                        max_extra: int) -> int:
        """Worst-case KV tokens a request ever holds: the prompt plus one
        write per decode step (the final emitted token is never written)."""
        return prompt_len + max(budget + max_extra - 1, 0)

    def _reserve_blocks(self, prompt_len: int, budget: int,
                        max_extra: int) -> int:
        return max(1, math.ceil(
            self._reserve_tokens(prompt_len, budget, max_extra)
            / self.block_size))

    def _grow_slot_blocks(self, i: int, cover_tokens: int) -> None:
        """Assign physical blocks to slot ``i`` up to ``cover_tokens``
        logical positions (capped at the slot's reservation)."""
        need = min(math.ceil(cover_tokens / self.block_size),
                   self._slot_reserved[i])
        have = len(self._slot_blocks[i])
        if need <= have:
            return
        new = self.allocator.alloc(need - have)
        self._tables_host[i, have:need] = new
        self._slot_blocks[i].extend(new)
        self._tables_dirty = True

    def _ensure_blocks(self, steps: int) -> None:
        """Alloc on a chunk boundary: every live slot gets blocks covering
        its next ``steps`` decode writes. The reservation caps the cover,
        so the free list cannot run dry; writes past the cap land on the
        trash block and belong to discarded post-retire tokens."""
        for i, s in enumerate(self.slots):
            if s is not None:
                self._grow_slot_blocks(i, s.cache_len + steps)

    def _sync_tables(self) -> None:
        """Copy the host block table to the device if it changed."""
        if self._tables_dirty:
            self._pool.block_tables.copy_(
                torch.from_numpy(self._tables_host))
            self._tables_dirty = False

    def _retire_slot(self, i: int) -> None:
        """Free on retire: return the slot's blocks and reservation, and
        sentinel its table row so its dead-row writes hit the trash block."""
        self.slots[i] = None
        if not self.paged:
            return
        self.allocator.free(self._slot_blocks[i])
        self.allocator.release(self._slot_reserved[i])
        self._slot_blocks[i] = []
        self._slot_reserved[i] = 0
        self._tables_host[i, :] = self.n_blocks
        self._tables_dirty = True

    # ------------------------------------------------------------------ api
    def admit(self, rid: int, prompt: np.ndarray, budget: int,
              max_extra: int = 4) -> bool:
        """Prefill a request and place it in a free slot; False if full."""
        return self.admit_many([(rid, prompt, budget, max_extra)])[0]

    def admit_many(self, requests: Sequence[Tuple]) -> list:
        """Admit queued requests ``(rid, prompt, budget, max_extra)`` in
        batched prefills: one right-padded group on the full-attention
        backbone, else one group per prompt length, in order of first
        appearance (capacity-dispatch MoE: one request a group). Returns
        per-request admission flags; admission is FIFO over the list and
        stops at the first request that does not fit (out of rows, or,
        paged, out of pool tokens).

        Admission always emits the prefill's first token, so every request
        produces ``max(budget + max_extra, 1)`` tokens.
        """
        free = [i for i, s in enumerate(self.slots) if s is None]
        flags = [False] * len(requests)
        batch = []
        for j, req in enumerate(requests):
            if len(batch) >= len(free):
                break
            if self.paged:
                _, prompt, budget, max_extra = req
                if len(prompt) > self.capacity:
                    break
                nres = self._reserve_blocks(len(prompt), budget, max_extra)
                if not self.allocator.reserve(nres):
                    break
                self._slot_reserved[free[len(batch)]] = nres
            batch.append((free[len(batch)], req))
            flags[j] = True
        if not batch:
            return flags
        if self._can_pad_batch():
            groups = [batch]
        else:       # recurrent, hybrid, windowed: equal lengths, no pads
            by_len: dict = {}
            for item in batch:
                by_len.setdefault(len(item[1][1]), []).append(item)
            groups = list(by_len.values())
        rows = self._batch_rows()
        if rows < max(len(g) for g in groups):   # capacity MoE, Zamba2
            groups = [g[i:i + rows] for g in groups
                      for i in range(0, len(g), rows)]
        for group in groups:
            self._admit_group(group)
        return flags

    def _admit_group(self, group) -> None:
        """One prefill of the group (right-padded to its longest prompt)
        and one insert."""
        lengths = np.asarray([len(req[1]) for _, req in group],
                             dtype=np.int64)
        S = int(lengths.max())
        traced = self.tracer is not None
        tr = self.tracer if traced else NULL_TRACER
        routing = self._prefill_routing() if traced else None
        with tr.span("continuous.admit", cat="engine",
                     args={"rows": len(group), "S": S}):
            with moe.count_routing(routing):
                firsts = self._prefill_insert(group, lengths, S)
            with tr.span("continuous.admit.read", cat="engine"):
                firsts = graph_hooks.to_host(firsts, "continuous.admit")
        if traced:
            with tr.span("continuous.admit.stats", cat="engine") as args:
                if routing is not None:
                    args.update(self._prefill_stats(routing, len(group), S))
        for r, (slot, (rid, _, budget, max_extra)) in enumerate(group):
            first = int(firsts[r])
            self.slots[slot] = Slot(
                rid=rid, budget=budget, max_extra=max_extra, generated=1,
                tokens=[first], last_token=first,
                prompt_len=int(lengths[r]))

    def _prefill_routing(self) -> Optional[moe.RoutingCounts]:
        """The prefill's routing counts ``[L, 1, E]`` (MoE only), made
        once."""
        if not self._counts_routing():
            return None
        if self._prefill_counts is None:
            self._prefill_counts = moe.RoutingCounts(
                self.cfg.n_layers, self.cfg.moe.n_experts, self.device)
        return self._prefill_counts

    def _prefill_stats(self, routing: moe.RoutingCounts, rows: int,
                       S: int) -> dict:
        """``continuous.admit.stats``' args from a prefill of ``rows``
        prompts padded to ``S``: its pairs routed, kept under the
        capacity, and the (layer, expert) pairs hit."""
        counts = graph_hooks.to_host(routing.counts, "continuous.routing")
        T, m = rows * S, self.cfg.moe
        # a one-token prompt and the ragged dispatch drop nothing
        C = moe.capacity(self.cfg, T) if m.impl == "capacity" and S > 1 \
            else T
        return {"pairs": T * m.top_k * counts.shape[0],
                "kept": int(np.minimum(counts, C).sum()),
                "experts_hit": int(np.count_nonzero(counts))}

    def _prefill_insert(self, group, lengths: np.ndarray,
                        S: int) -> torch.Tensor:
        """Prefill the group's prompts right-padded to ``S``, insert their
        K/V into the cache, and return the first tokens (on the device).

        The host's rows go to the device before ``forward``: such a copy
        waits for the stream, so none may follow the enqueued prefill,
        and on the paged pool the caller's read of the first tokens
        waits for the device's tail alone (the slot cache's insert still
        copies its seed positions after it)."""
        tokens = np.zeros((len(group), S), dtype=np.int64)
        for r, (_, req) in enumerate(group):
            tokens[r, :lengths[r]] = req[1]
        slots = [slot for slot, _ in group]
        if self.paged:
            # assign the prompt's blocks first so the insert lands on them
            for slot, (_, prompt, _, _) in group:
                self._grow_slot_blocks(slot, len(prompt))
            self._sync_tables()
        lengths_d = self._rows(lengths)
        slot_idx = self._rows(slots)
        rids = self._rows([req[0] for _, req in group])
        out = forward(self.cfg, self.params,
                      torch.from_numpy(tokens).to(self.device),
                      return_cache=True)
        last = out.logits[torch.arange(len(group), device=self.device),
                          lengths_d - 1]                          # [k, V]
        firsts = self._next_tokens(
            last, rids, torch.zeros_like(lengths_d))   # first token: g = 0
        lengths_d = lengths_d.to(torch.int32)
        tr = (self.tracer if self.tracer is not None
              and self.cfg.published_hybrid else NULL_TRACER)
        with tr.span("continuous.admit.insert", cat="engine"):
            self._insert(out.cache, slot_idx, lengths_d)
        return firsts

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def tokens_in_use(self) -> int:
        """KV tokens currently held by live requests (prompt + generated
        so far): the occupancy the paged pool is gated on."""
        return sum(s.cache_len for s in self.slots if s is not None)

    @property
    def pool_tokens(self) -> int:
        """Total KV token capacity (pool blocks, or slot rows x capacity)."""
        if self.paged:
            return self.n_blocks * self.block_size
        return self.max_slots * self.capacity

    @property
    def pool_fill(self) -> float:
        """Fraction of the KV pool held by live requests."""
        return self.tokens_in_use / max(self.pool_tokens, 1)

    @property
    def blocks_in_use(self) -> int:
        return self.allocator.n_allocated if self.paged else 0

    def check_block_invariants(self) -> bool:
        """Audit the paged pool against this engine's slot state: the
        allocator's balance against the per-slot block lists, and the slot
        reservations against the allocator's reservation counter (covered,
        ``>=``: an external tenant such as ``faults.PoolPressure`` may
        hold a reservation of its own). ``True`` on a slot engine."""
        if not self.paged:
            return True
        held = sum(len(b) for b in self._slot_blocks)
        self.allocator.check_balance(in_use=held)
        slot_res = sum(self._slot_reserved)
        if self.allocator.reserved < slot_res:
            raise AssertionError(
                f"slot reservations {slot_res} exceed allocator "
                f"reservation counter {self.allocator.reserved}")
        return True

    def step(self) -> list:
        """One decode step for all active slots; returns finished Slots.

        The per-token reference path: one decode step and one host read
        per token (``step_chunk(1)``, whose top runs the fault hook once).
        ``step_chunk`` has the same semantics.
        """
        return self.step_chunk(1)

    def step_chunk(self, chunk: Optional[int] = None) -> list:
        """Advance every active slot by up to ``chunk`` tokens; returns the
        Slots that finished inside the chunk.

        The chunk's decode steps are ``chunk`` replays of the step
        captured for this ``chunk`` (eager on a CPU device), with their
        tokens on the device, and the host reads them once at the end. Admissions happen
        at chunk boundaries; a slot whose remaining budget is shorter than
        the chunk retires mid-chunk (its surplus steps are discarded here;
        in paged mode its surplus writes past its reservation land on the
        trash block).
        """
        if self.faults is not None:
            self.faults.on_decode_step(self)
        chunk = self.chunk if chunk is None else chunk
        if self.n_active == 0 or chunk <= 0:
            return []
        traced = self.tracer is not None
        tr = self.tracer if traced else NULL_TRACER
        with tr.span("continuous.chunk.prepare", cat="engine"):
            if self.paged:
                self._ensure_blocks(chunk)
                self._sync_tables()
            # the slots' state into the static inputs in one host-to-device
            # copy, before any replay (empty rows decode throwaway tokens)
            self._inputs.copy_(torch.tensor(
                [[s.last_token if s else 0 for s in self.slots],
                 [s.rid if s else 0 for s in self.slots],
                 [s.generated if s else 0 for s in self.slots]],
                dtype=torch.long))
            fresh = chunk not in self._outs      # this chunk captures
            step = self._chunk_step(chunk)
        events = self._chunk_events(chunk, fresh) if traced else None
        with tr.span("continuous.decode_chunk", cat="engine",
                     args={"chunk": chunk, "occupancy": self.n_active,
                           "tokens_in_use": self.tokens_in_use}):
            if events is not None:
                events[0].record()
            for i in range(chunk):
                self._graphs.run(chunk, step)
                if events is not None:
                    events[i + 1].record()
            toks = graph_hooks.to_host(self._outs[chunk][0],
                                       self._graphs.label)   # [chunk, slots]
        if traced:
            with tr.span("continuous.chunk.stats", cat="engine") as args:
                args.update(self._chunk_stats(chunk, events))
        with tr.span("continuous.chunk.retire", cat="engine"):
            finished = []
            for i, s in enumerate(self.slots):
                if s is None:
                    continue
                n_take = min(chunk, s.budget + s.max_extra - s.generated)
                if n_take > 0:
                    s.tokens.extend(int(t) for t in toks[:n_take, i])
                    s.generated += n_take
                    s.last_token = int(toks[n_take - 1, i])
                if s.generated >= s.budget + s.max_extra:
                    finished.append(s)
                    self._retire_slot(i)
        return finished

    def _chunk_events(self, chunk: int, fresh: bool) -> Optional[list]:
        """On a CUDA device, the ``chunk + 1`` timing events of a chunk of
        two or more steps that replays its graph, one set a chunk size;
        else None."""
        if self.device.type != "cuda" or chunk < 2 or fresh:
            return None
        if chunk not in self._events:
            self._events[chunk] = [torch.cuda.Event(enable_timing=True)
                                   for _ in range(chunk + 1)]
        return self._events[chunk]

    def _chunk_stats(self, chunk: int, events: Optional[list]) -> dict:
        """``continuous.chunk.stats``' args: the device's step times from
        the chunk's events (complete: its read synchronised) and the
        routing counts of its steps."""
        out = {}
        if events is not None:
            out["first_step_ms"] = events[0].elapsed_time(events[1])
            out["step_ms"] = (events[1].elapsed_time(events[chunk])
                              / (chunk - 1))
            times = (self._phases.times_ms() if self._phases is not None
                     else None)
            if times is not None:
                out.update(mamba_ms=times.get("mamba", 0.0),
                           shared_ms=times.get("shared", 0.0))
        if self.cfg.published_hybrid:
            if self.paged:
                out["kv_blocks"] = self.allocator.n_allocated
            out["state_rows"] = self.max_slots
        routing = self._routing.get(chunk)
        if routing is not None:
            counts = graph_hooks.to_host(routing.counts, "continuous.routing")
            out.update(pairs=(self.max_slots * self.cfg.moe.top_k
                              * counts.shape[0] * chunk),
                       experts_hit=int(np.count_nonzero(counts)))
        return out
