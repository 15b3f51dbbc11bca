"""Slot decode attention: the Hopper kernel wrapper and its plain version.

Counterpart of ``repro.kernels.decode_attention.decode_attention`` (the
Pallas TPU slot kernel; the paged kernel of that module is not ported yet).
The CUDA source is ``csrc/decode_attention.cu``. Layouts split the TPU
kernel's ``Bkv`` into batch and kv head, so the stacked decode cache
``[B, C, nkv, hd]`` passes as a strided view without a copy:

    q      [B, H, G, hd]    contiguous
    k, v   [B, H, C, hd]    any strides, hd contiguous
    valid  [B, C] bool      one mask per batch row, shared by its kv heads
    out    [B, H, G, hd]

(The TPU kernel took ``valid`` repeated to ``[Bkv, C]``; indexing it by
batch row computes the same function.) Masking follows the TPU kernel:
-1e30 for masked scores, a 1e-30 clamp on the denominator, weights rounded
to the cache dtype before the P.V product.
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
