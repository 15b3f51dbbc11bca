"""The MoE dispatch's pair ranks: the Hopper kernel wrapper and its plain
version.

No TPU kernel: the JAX package ranks the (token, expert) pairs with a
stable argsort (``repro.models.moe``); the CUDA source is
``csrc/moe_ranks.cu``. For the flat pairs ``t k + j`` of ``idx [T, k]``
(int64, experts in ``[0, E)``):

    pos       [T k] int64   each pair's rank among its expert's pairs, in
                            flat order (its place in the stable argsort,
                            less its expert's start)
    sizes     [E] int32     the pairs per expert

and, with ``capacity`` C > 0 (the ``[E, C, d]`` buffer of
``models/moe.py``'s dispatch):

    rows_in   [T k] int64   the buffer row each pair is written to,
                            ``e C + pos``, or the spare row ``E C`` when
                            ``pos >= C`` (the pair is dropped)
    rows_out  [T k] int64   the row its output is read from, ``e C + pos``,
                            or pair 0's row (rank 0, always kept) when
                            dropped

No host read and static shapes, so the call can be captured in a CUDA
graph; the kernel ranks without atomics, so its result is exact. The
plain version counts a one-hot ``[T k, E]`` down its rows; it is the
oracle, and only a CPU tensor takes it.
"""
from __future__ import annotations

import torch

from . import LAUNCHES, _cuda

#: the most experts the kernel's shared counts hold (csrc/moe_ranks.cu
#: kMaxExperts)
MAX_EXPERTS = 256
#: the most pairs the kernel takes (csrc/moe_ranks.cu)
MAX_PAIRS = 1 << 30


def moe_ranks_plain(idx, n_experts: int, capacity: int = 0) -> tuple:
    """(pos, sizes, rows_in, rows_out) from a one-hot's cumulative count;
    the rows are None without a capacity."""
    flat_e = idx.reshape(-1)
    hit = (flat_e[:, None] == torch.arange(n_experts, device=idx.device)) \
        .to(torch.int32)                                       # [T k, E]
    before = torch.cumsum(hit, 0) - hit
    pos = before.gather(1, flat_e[:, None])[:, 0]
    sizes = hit.sum(0, dtype=torch.int32)
    if not capacity:
        return pos, sizes, None, None
    keep = pos < capacity
    slot = flat_e * capacity + pos
    return (pos, sizes, torch.where(keep, slot, n_experts * capacity),
            torch.where(keep, slot, slot[0]))


def moe_ranks(idx, n_experts: int, capacity: int = 0) -> tuple:
    """(pos, sizes, rows_in, rows_out) of the pairs of ``idx``. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises (more than ``MAX_EXPERTS`` experts among its refusals)."""
    _cuda.refuse_dtensor("moe_ranks", (idx,))
    if idx.device.type == "cpu":
        return moe_ranks_plain(idx, n_experts, capacity)
    return _launch(idx, n_experts, capacity)


def _launch(idx, n_experts: int, capacity: int = 0) -> tuple:
    name = "moe_ranks"
    dev = idx.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {dev}")
    if idx.dtype != torch.int64 or not idx.is_contiguous():
        raise ValueError(f"{name}: idx must be a contiguous int64 tensor, "
                         f"got {idx.dtype} {tuple(idx.shape)}")
    n = idx.numel()
    if n > MAX_PAIRS or not 1 <= n_experts <= MAX_EXPERTS or capacity < 0:
        raise ValueError(f"{name}: {n} pairs over {n_experts} experts at "
                         f"capacity {capacity} (at most {MAX_PAIRS} pairs "
                         f"and {MAX_EXPERTS} experts)")
    pos = torch.empty(n, dtype=torch.int64, device=dev)
    sizes = torch.empty(n_experts, dtype=torch.int32, device=dev)
    rows = (torch.empty((2, n), dtype=torch.int64, device=dev) if capacity
            else None)
    fn = _cuda.entry(name, "moe_ranks_fwd", [_cuda.P] * 5 + [_cuda.I] * 3
                     + [_cuda.P])
    err = fn(idx.data_ptr(), pos.data_ptr(), sizes.data_ptr(),
             None if rows is None else rows[0].data_ptr(),
             None if rows is None else rows[1].data_ptr(), n, n_experts,
             capacity, _cuda.stream_ptr(dev))
    _cuda.raise_on(name, err)
    LAUNCHES[name] += 1
    if rows is None:
        return pos, sizes, None, None
    return pos, sizes, rows[0], rows[1]
