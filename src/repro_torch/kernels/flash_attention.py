"""Prefill flash attention: the Hopper kernel wrapper and its plain version.

Counterpart of ``repro.kernels.flash_attention.flash_attention`` (Pallas
TPU); the CUDA source is ``csrc/flash_attention.cu``. Layouts split the
TPU kernel's leading ``Bkv`` into batch and kv head, so the model's
``[B, S, nh, hd]`` projections pass as strided views without a copy:

    q    [B, H, G, S, hd]   (H = kv heads, G = query heads per kv head)
    k, v [B, H, S, hd]
    out  [B, H, G, S, hd]

The TPU layout ``[Bkv, G, S, hd]`` is the case ``B = Bkv, H = 1``.
Masking follows the TPU kernel: -1e30 for masked scores and a 1e-30 clamp
on the softmax denominator; the weights are rounded to the input dtype
before the P.V product.
"""
from __future__ import annotations

import torch

from . import LAUNCHES, _cuda

NEG_INF = -1e30


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None) -> torch.Tensor:
    """Plain PyTorch version with the kernel's arithmetic (f32 scores and
    accumulation, weights rounded to the input dtype)."""
    S, hd = q.shape[-2], q.shape[-1]
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.float(), k.float()) \
        * (1.0 / hd ** 0.5)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return (out / l.clamp_min(1e-30)).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Causal (optionally windowed) prefill attention; see module docstring.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises. The kernel's output is a ``[B, H, G, S, hd]`` view of
    a ``[B, S, H, G, hd]`` buffer (the model's layout).
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return _launch(q, k, v, causal, window)


def _launch(q, k, v, causal, window):
    name = "flash_attention"
    dev = _cuda.check(name, {"q": q, "k": k, "v": v})
    B, H, G, S, hd = q.shape
    if tuple(k.shape) != (B, H, S, hd) or tuple(v.shape) != (B, H, S, hd):
        raise ValueError(f"{name}: k/v shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if hd > 256:
        raise ValueError(f"{name}: head_dim {hd} > 256 is not supported")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be positive, got {window}")
    out = torch.empty((B, S, H, G, hd), dtype=q.dtype,
                      device=dev).permute(0, 2, 3, 1, 4)
    fn = _cuda.entry(name, "flash_attention_fwd",
                     [_cuda.I, _cuda.P, _cuda.P, _cuda.P, _cuda.P,
                      _cuda.LL_PTR] + [_cuda.I] * 7 + [_cuda.F, _cuda.P])
    st = _cuda.strides((q, (0, 1, 2, 3)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                       (out, (0, 1, 2, 3)))
    err = fn(_cuda.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
             v.data_ptr(), out.data_ptr(), st, B, H, G, S, hd, int(causal),
             -1 if window is None else int(window), 1.0 / hd ** 0.5,
             _cuda.stream_ptr(dev))
    _cuda.raise_on(name, err)
    LAUNCHES[name] += 1
    return out
