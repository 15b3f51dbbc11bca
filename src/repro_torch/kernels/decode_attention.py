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
"""
from __future__ import annotations

import torch

from . import LAUNCHES, _cuda

NEG_INF = -1e30


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
    if hd > 256:
        raise ValueError(f"{name}: head_dim {hd} > 256 is not supported")
    out = torch.empty_like(q)
    fn = _cuda.entry(name, "decode_attention_fwd",
                     [_cuda.I] + [_cuda.P] * 5 + [_cuda.LL_PTR]
                     + [_cuda.I] * 5 + [_cuda.F, _cuda.P])
    st = _cuda.strides((k, (0, 1, 2)), (v, (0, 1, 2)))
    err = fn(_cuda.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
             v.data_ptr(), valid.data_ptr(), out.data_ptr(), st, B, H, G, C,
             hd, 1.0 / hd ** 0.5, _cuda.stream_ptr(dev))
    _cuda.raise_on(name, err)
    LAUNCHES[name] += 1
    return out


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
    if hd > 256:
        raise ValueError(f"{name}: head_dim {hd} > 256 is not supported")
    out = torch.empty_like(q)
    fn = _cuda.entry(name, "paged_decode_attention_fwd",
                     [_cuda.I] + [_cuda.P] * 6 + [_cuda.LL_PTR]
                     + [_cuda.I] * 7 + [_cuda.F, _cuda.P])
    st = _cuda.strides((k_pool, (0, 1, 2)), (v_pool, (0, 1, 2)))
    err = fn(_cuda.DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
             v_pool.data_ptr(), block_tables.data_ptr(), pos.data_ptr(),
             out.data_ptr(), st, B, H, G, P, bs, block_tables.shape[1], hd,
             1.0 / hd ** 0.5, _cuda.stream_ptr(dev))
    _cuda.raise_on(name, err)
    LAUNCHES[name] += 1
    return out
