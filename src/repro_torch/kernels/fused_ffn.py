"""Fused SwiGLU FFN: the Hopper kernel wrapper and its plain version.

Counterpart of ``repro.kernels.fused_ffn.fused_ffn`` (Pallas TPU); the CUDA
source is ``csrc/fused_ffn.cu``. Layouts are the TPU kernel's:

    x  [E, T, d]      wg, wu [E, d, f]      wd [E, f, d]      y [E, T, d]

all contiguous. ``h = silu(x wg) * (x wu)`` is formed in f32 and rounded to
the input dtype before the down projection, as in the TPU kernel.
"""
from __future__ import annotations

import torch

from . import LAUNCHES, _cuda

_BF = 32         # d_ff columns per chunk (csrc/fused_ffn.cu kBF)
_PARTS = 8       # warps splitting the d reduction (csrc/fused_ffn.cu kParts)
_SMEM_MAX = 227 * 1024


def fused_ffn_plain(x, wg, wu, wd) -> torch.Tensor:
    """Plain PyTorch version with the kernel's arithmetic."""
    g = torch.matmul(x.float(), wg.float())
    u = torch.matmul(x.float(), wu.float())
    h = (torch.nn.functional.silu(g) * u).to(x.dtype)
    return torch.matmul(h.float(), wd.float()).to(x.dtype)


def fused_ffn(x, wg, wu, wd) -> torch.Tensor:
    """SwiGLU FFN batched over E. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return fused_ffn_plain(x, wg, wu, wd)
    return _launch(x, wg, wu, wd)


def _smem_bytes(bt: int, d: int) -> int:
    """Shared memory of a CTA of ``bt`` rows (csrc/fused_ffn.cu smem_bytes)."""
    return 4 * bt * (2 * d + 2 * _PARTS * _BF + _BF)


def _launch_shape(n_rows: int, E: int, f: int, sms: int, d: int) -> tuple:
    """(rows per CTA, number of d_ff shares): the row tile is cut until its
    shared memory fits a CTA (at d = 3584 a 16-row tile needs 482 KB), and
    shares are added until the grid covers about two CTAs per SM."""
    bt = 1 if n_rows == 1 else (4 if n_rows <= 4 else 16)
    while bt > 1 and _smem_bytes(bt, d) > _SMEM_MAX:
        bt //= 4
    tiles = -(-n_rows // bt) * E
    n_chunks = -(-f // _BF)
    return bt, max(1, min(n_chunks, -(-2 * sms // tiles)))


def _launch(x, wg, wu, wd):
    name = "fused_ffn"
    dev = _cuda.check(name, {"x": x, "wg": wg, "wu": wu, "wd": wd})
    E, T, d = x.shape
    f = wg.shape[-1]
    if (tuple(wg.shape) != (E, d, f) or tuple(wu.shape) != (E, d, f)
            or tuple(wd.shape) != (E, f, d)):
        raise ValueError(f"{name}: weight shapes {tuple(wg.shape)}, "
                         f"{tuple(wu.shape)}, {tuple(wd.shape)} do not match "
                         f"x {tuple(x.shape)}")
    for arg, t in (("x", x), ("wg", wg), ("wu", wu), ("wd", wd)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    bt, n_split = _launch_shape(T, E, f, _cuda.sm_count(dev.index or 0),
                                 d)
    y = torch.empty_like(x)
    scratch = torch.empty(n_split * E * T * d, dtype=torch.float32,
                          device=dev)
    fn = _cuda.entry(name, "fused_ffn_fwd",
                     [_cuda.I] + [_cuda.P] * 6 + [_cuda.I] * 6 + [_cuda.P])
    err = fn(_cuda.DTYPE_CODES[x.dtype], x.data_ptr(), wg.data_ptr(),
             wu.data_ptr(), wd.data_ptr(), y.data_ptr(), scratch.data_ptr(),
             E, T, d, f, bt, n_split, _cuda.stream_ptr(dev))
    _cuda.raise_on(name, err)
    LAUNCHES[name] += 1
    return y
