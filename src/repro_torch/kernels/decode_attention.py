"""Decode attention, slot and paged: the Hopper kernel wrappers and their
plain versions.

Counterparts of ``repro.kernels.decode_attention.decode_attention`` (the
Pallas TPU slot kernel; CUDA source ``csrc/decode_attention.cu``) and
``paged_decode_attention`` (the Pallas paged kernel; CUDA source
``csrc/paged_decode_attention.cu``).

Slot kernel. Layouts split the TPU kernel's ``Bkv`` into batch and kv
head, so the stacked decode cache ``[B, C, nkv, hd]`` passes as a strided
view without a copy:

    q      [B, H, G, hd]    contiguous
    k, v   [B, H, C, hd]    any strides, hd contiguous
    valid  [B, C] bool      one mask per batch row, shared by its kv heads
    out    [B, H, G, hd]

(The TPU kernel took ``valid`` repeated to ``[Bkv, C]``; indexing it by
batch row computes the same function.)

Paged kernel, the TPU kernel's layouts (one layer of the pool):

    q             [B, H, G, hd]     contiguous
    k/v_pool      [P, bs, H, hd]    any strides, hd contiguous (a per-layer
                                    view of the stacked pool, no copy)
    block_tables  [B, n_bt] int32   entry P (one past the pool) = sentinel
    pos           [B] int32         position of the new token per slot
    out           [B, H, G, hd]

Logical position ``j * bs + off`` of slot ``b`` is visible when it is
``<= pos[b]`` and ``block_tables[b, j] < P``. Both kernels mask as the TPU
kernels do: -1e30 for masked scores, a 1e-30 clamp on the denominator,
weights rounded to the cache dtype before the P.V product.

On the card both kernels split each row's KV walk across CTAs
(``split_plan``); the CTAs of one row form a thread block cluster and
merge their partial softmax states through distributed shared memory, in
split order, within the one launch.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import LAUNCHES, _cuda

NEG_INF = -1e30
#: most splits per (batch, kv head): the largest portable thread block
#: cluster (``kMaxSplit`` in csrc/decode_split.cuh)
SPLIT_MAX = 8
#: fewest splits of a row that holds two tiles or more, so that one long
#: row never sits on a single CTA when many rows fill the card
SPLIT_MIN = 2
#: a tile holds about this many bytes of K rows (64 rows at bf16 hd 128)
TILE_BYTES = 16384
MAX_G = 16                       # query heads per kv head (kMaxG)


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How a decode kernel cuts each (batch, kv head) row's positions:
    tiles of ``tile`` positions, tile ``t`` walked by split
    ``t % n_split``."""
    tile: int
    n_tiles: int
    n_split: int

    def tiles(self, split: int) -> range:
        """The tiles split ``split`` walks, in order."""
        return range(split, self.n_tiles, self.n_split)


def split_plan(B: int, nkv: int, n_pos: int, hd: int, dtype,
               sm_count: int, block_size: int | None = None) -> SplitPlan:
    """The split plan, from shapes alone: no tensor is read, so the
    launch needs no host sync and a CUDA graph could capture it.

    ``n_pos`` is the slot cache's C or the paged table's ``n_bt * bs``.
    A tile holds about ``TILE_BYTES`` of K rows (64 positions up to
    256-byte rows); for the paged kernel it is the smallest multiple of
    ``block_size`` that reaches that, or that many positions inside a
    larger block. ``n_split`` aims at one CTA per SM (the splits of a row
    form a cluster that holds its SMs until its slowest split ends, so
    more CTAs than SMs queue), within ``SPLIT_MIN`` .. ``SPLIT_MAX`` and
    the tile count. Tiles are dealt round-robin, so a short prefix of a
    long cache lands on several splits."""
    row_bytes = hd * torch.finfo(dtype).bits // 8
    target = min(64, TILE_BYTES // row_bytes)      # hd <= 256: >= 16
    tile = target
    if block_size is not None and block_size <= target:
        tile = block_size * math.ceil(target / block_size)
    n_tiles = math.ceil(n_pos / tile)
    want = max(SPLIT_MIN, min(SPLIT_MAX, math.ceil(sm_count / (B * nkv))))
    return SplitPlan(tile, n_tiles, min(n_tiles, want))


def decode_attention_plain(q, k, v, valid) -> torch.Tensor:
    """Plain PyTorch version with the kernel's arithmetic."""
    hd = q.shape[-1]
    s = torch.einsum("bhgd,bhcd->bhgc", q.float(), k.float()) \
        * (1.0 / hd ** 0.5)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgc,bhcd->bhgd", p.to(v.dtype).float(), v.float())
    return (out / l.clamp_min(1e-30)).to(q.dtype)


def decode_attention(q, k, v, valid) -> torch.Tensor:
    """One query token per (batch, head) over the slot cache.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, valid)
    return _launch(q, k, v, valid)


def _launch(q, k, v, valid):
    name = "decode_attention"
    dev = _cuda.check(name, {"q": q, "k": k, "v": v})
    B, H, G, hd = q.shape
    C = k.shape[2]
    if tuple(k.shape) != (B, H, C, hd) or tuple(v.shape) != (B, H, C, hd):
        raise ValueError(f"{name}: k/v shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous")
    if (valid.dtype != torch.bool or tuple(valid.shape) != (B, C)
            or not valid.is_contiguous() or valid.device != dev):
        raise ValueError(f"{name}: valid must be a contiguous bool [B, C] "
                         f"tensor on {dev}")
    _check_heads(name, G, hd)
    plan = split_plan(B, H, C, hd, q.dtype, _cuda.sm_count(dev.index or 0))
    out = torch.empty_like(q)
    fn = _cuda.entry(name, "decode_attention_fwd",
                     [_cuda.I] + [_cuda.P] * 5 + [_cuda.LL_PTR]
                     + [_cuda.I] * 7 + [_cuda.F, _cuda.P])
    st = _cuda.strides((k, (0, 1, 2)), (v, (0, 1, 2)))
    err = fn(_cuda.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
             v.data_ptr(), valid.data_ptr(), out.data_ptr(), st, B, H, G, C,
             hd, plan.tile, plan.n_split, 1.0 / hd ** 0.5,
             _cuda.stream_ptr(dev))
    _cuda.raise_on(name, err)
    LAUNCHES[name] += 1
    return out


def _check_heads(name: str, G: int, hd: int) -> None:
    if hd > 256:
        raise ValueError(f"{name}: head_dim {hd} > 256 is not supported")
    if G > MAX_G:
        raise ValueError(f"{name}: {G} query heads per kv head > {MAX_G} "
                         f"is not supported")


def paged_gather(k_pool, v_pool, block_tables, pos):
    """Densify a paged pool through its block table.

    Returns k, v ``[B, n_bt * bs, H, hd]`` (sentinel entries clipped to
    block P - 1, as the TPU kernel's index map clips them) and the mask
    ``valid [B, n_bt * bs]`` of the positions the kernel sees: ``<= pos``
    and behind a non-sentinel entry."""
    B, n_bt = block_tables.shape
    P, bs, H, hd = k_pool.shape
    gather = block_tables.long().clamp(0, P - 1)            # [B, n_bt]
    k = k_pool[gather].reshape(B, n_bt * bs, H, hd)
    v = v_pool[gather].reshape(B, n_bt * bs, H, hd)
    slots = torch.arange(n_bt * bs, device=k_pool.device)
    valid = (slots[None] <= pos.long()[:, None]) \
        & (block_tables < P).repeat_interleave(bs, dim=1)
    return k, v, valid


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                 pos) -> torch.Tensor:
    """Plain PyTorch version: gather the slot's blocks, mask, and attend
    with the slot kernel's arithmetic. A slot with no visible position
    averages V over the clipped block, as the TPU kernel does."""
    k, v, valid = paged_gather(k_pool, v_pool, block_tables, pos)
    return decode_attention_plain(q, k.permute(0, 2, 1, 3),
                                  v.permute(0, 2, 1, 3), valid)


def paged_decode_attention(q, k_pool, v_pool, block_tables,
                           pos) -> torch.Tensor:
    """One query token per slot over a paged pool, through its block table.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            pos)
    return _launch_paged(q, k_pool, v_pool, block_tables, pos)


def _launch_paged(q, k_pool, v_pool, block_tables, pos):
    name = "paged_decode_attention"
    dev = _cuda.check(name, {"q": q, "k_pool": k_pool, "v_pool": v_pool})
    B, H, G, hd = q.shape
    P, bs = k_pool.shape[:2]
    if (tuple(k_pool.shape) != (P, bs, H, hd)
            or tuple(v_pool.shape) != (P, bs, H, hd)):
        raise ValueError(f"{name}: pool shapes {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous")
    if (block_tables.dtype != torch.int32 or block_tables.dim() != 2
            or block_tables.shape[0] != B or block_tables.device != dev
            or not block_tables.is_contiguous()):
        raise ValueError(f"{name}: block_tables must be a contiguous int32 "
                         f"[B, n_bt] tensor on {dev}")
    if (pos.dtype != torch.int32 or tuple(pos.shape) != (B,)
            or pos.device != dev or not pos.is_contiguous()):
        raise ValueError(f"{name}: pos must be a contiguous int32 [B] "
                         f"tensor on {dev}")
    _check_heads(name, G, hd)
    n_bt = block_tables.shape[1]
    plan = split_plan(B, H, n_bt * bs, hd, q.dtype,
                      _cuda.sm_count(dev.index or 0), block_size=bs)
    out = torch.empty_like(q)
    fn = _cuda.entry(name, "paged_decode_attention_fwd",
                     [_cuda.I] + [_cuda.P] * 6 + [_cuda.LL_PTR]
                     + [_cuda.I] * 9 + [_cuda.F, _cuda.P])
    st = _cuda.strides((k_pool, (0, 1, 2)), (v_pool, (0, 1, 2)))
    err = fn(_cuda.DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
             v_pool.data_ptr(), block_tables.data_ptr(), pos.data_ptr(),
             out.data_ptr(), st, B, H, G, P, bs, n_bt, hd, plan.tile,
             plan.n_split, 1.0 / hd ** 0.5, _cuda.stream_ptr(dev))
    _cuda.raise_on(name, err)
    LAUNCHES[name] += 1
    return out
