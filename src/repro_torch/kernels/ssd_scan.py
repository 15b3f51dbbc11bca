"""Mamba2 SSD chunked scan: the Hopper kernel wrapper and its plain version.

Counterpart of ``repro.kernels.ssd_scan.ssd_scan`` (Pallas TPU); the CUDA
source is ``csrc/ssd_scan.cu``. Layouts split the TPU kernel's leading
``BH`` into batch and head, so the model's tensors pass as strided views
without a copy:

    x       [B, H, S, hd]   f32 or bf16, any strides, hd contiguous
    dt, a   [B, H, S]       f32 step sizes (> 0) and log decays (< 0),
                            any strides
    Bm, Cm  [B, H, S, ds]   x's dtype, any strides, ds contiguous; the
                            model shares one [B, S, ds] row among its heads
                            and passes it with a head stride of 0
    y       [B, H, S, hd]   x's dtype; the kernel's is a view of a
                            [B, S, H, hd] buffer (the model's layout)
    s_final [B, H, hd, ds]  f32

The TPU layout ``[BH, S, ...]`` is the case ``H = 1``. The function, from
a zero state (``D x`` stays outside, as in both JAX versions):

    S_t = exp(a_t) S_{t-1} + dt_t x_t B_t^T        y_t = S_t C_t

Both versions take it in chunks of ``CHUNK`` tokens: the intra-chunk part
is the score matrix ``(C_i . B_j) exp(cum_i - cum_j) dt_j`` for ``j <= i``
(the exponent is formed only there, where it is ``<= 0``), the state is
carried across chunks, and scores stay in f32 as in the TPU kernel. Any S
is taken; the chunk length does not change the result.

On the card, :func:`ssd_plan` splits each head's ``hd`` channels over
CTAs from shapes alone (``scan_plan``); bf16 runs on tensor cores, f32 on
scalar FMAs.
"""
from __future__ import annotations

import torch

from . import LAUNCHES, _cuda
from .scan_plan import CHUNK, ScanPlan, make_plan, slice_width

MAX_HD = 64      # head dims and state sizes the kernel takes
MAX_DS = 64
#: ds padded inside a tensor-core CTA (csrc/ssd_scan.cu kDSP)
DS_PAD = 64


def tc_smem_bytes(width: int) -> int:
    """csrc/ssd_scan.cu tc_smem_bytes<P>: the x, B, C ring, w o B (hi and
    lo), the state's bf16 copy and the chunk's decays."""
    return 2 * (2 * CHUNK * (width + 8) + 6 * CHUNK * (DS_PAD + 8)
                + width * (DS_PAD + 8)) + 4 * 7 * CHUNK


def scalar_smem_bytes(width: int, ds: int) -> int:
    """csrc/ssd_scan.cu scalar_smem_bytes (f32 throughout)."""
    return 4 * (CHUNK * (width + 1) + 2 * CHUNK * (ds + 1) + CHUNK
                * (CHUNK + 1) + width * (ds + 1) + 5 * CHUNK)


def ssd_plan(B: int, H: int, S: int, hd: int, ds: int, dtype,
             sm_count: int) -> ScanPlan:
    """The launch plan, from shapes alone: bf16 on tensor cores, f32 on
    scalar FMAs, each head's x channels in slices (``scan_plan``)."""
    width = slice_width(B * H, hd, sm_count)
    if dtype == torch.bfloat16:
        return make_plan("tensor_core", B * H, S, hd, width,
                         tc_smem_bytes(width))
    return make_plan("scalar", B * H, S, hd, width,
                     scalar_smem_bytes(width, ds))


def ssd_scan_plain(x, dt, a, Bm, Cm, chunk: int = CHUNK):
    """Plain PyTorch version: the kernel's chunked arithmetic in f32, y
    rounded to x's dtype at the end."""
    B, H, S, hd = x.shape
    ds = Bm.shape[-1]
    xf, dtf, af, bf, cf = x.float(), dt.float(), a.float(), Bm.float(), \
        Cm.float()
    s = torch.zeros(B, H, hd, ds, dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        xq, dq, aq, bq, cq = xf[:, :, sl], dtf[:, :, sl], af[:, :, sl], \
            bf[:, :, sl], cf[:, :, sl]
        Q = xq.shape[2]
        cum = torch.cumsum(aq, dim=2)                    # inclusive [B,H,Q]
        causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(torch.where(causal, cum[..., :, None]
                                      - cum[..., None, :],
                                      torch.full((), -torch.inf,
                                                 device=x.device)))
        scores = torch.matmul(cq, bq.transpose(-1, -2)) * decay \
            * dq[..., None, :]
        y = torch.matmul(scores, xq) + torch.exp(cum)[..., None] \
            * torch.matmul(cq, s.transpose(-1, -2))
        w = dq * torch.exp(cum[..., -1:] - cum)          # [B, H, Q]
        s = torch.exp(cum[..., -1])[..., None, None] * s + torch.matmul(
            (xq * w[..., None]).transpose(-1, -2), bq)
        ys.append(y)
    return torch.cat(ys, dim=2).to(x.dtype), s


def ssd_scan(x, dt, a, Bm, Cm):
    """Mamba2 SSD scan; see the module docstring for layouts.

    Returns ``(y, s_final)``. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises.
    """
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, Bm, Cm)
    return _launch(x, dt, a, Bm, Cm)


def _launch(x, dt, a, Bm, Cm):
    name = "ssd_scan"
    dev = _cuda.check(name, {"x": x, "Bm": Bm, "Cm": Cm})
    B, H, S, hd = x.shape
    ds = Bm.shape[-1]
    for arg, t in (("Bm", Bm), ("Cm", Cm)):
        if tuple(t.shape) != (B, H, S, ds):
            raise ValueError(f"{name}: {arg} shape {tuple(t.shape)}, "
                             f"expected {(B, H, S, ds)}")
    for arg, t in (("dt", dt), ("a", a)):
        if (tuple(t.shape) != (B, H, S) or t.dtype != torch.float32
                or t.device != dev):
            raise ValueError(f"{name}: {arg} must be float32 [B, H, S] = "
                             f"{(B, H, S)} on {dev}")
    if not (1 <= hd <= MAX_HD and 1 <= ds <= MAX_DS and S >= 1):
        raise ValueError(f"{name}: head_dim {hd} (1..{MAX_HD}), d_state "
                         f"{ds} (1..{MAX_DS}) and S {S} (>= 1) not supported")
    y = torch.empty((B, S, H, hd), dtype=x.dtype,
                    device=dev).permute(0, 2, 1, 3)
    sf = torch.empty((B, H, hd, ds), dtype=torch.float32, device=dev)
    plan = ssd_plan(B, H, S, hd, ds, x.dtype, _cuda.sm_count(dev.index or 0))
    vec = (hd % 8 == 0 and ds % 8 == 0
           and _cuda.rows_aligned((x, (0, 1, 2)), (Bm, (0, 1, 2)),
                                  (Cm, (0, 1, 2))))
    fn = _cuda.entry(name, "ssd_scan_fwd",
                     [_cuda.I] + [_cuda.P] * 7 + [_cuda.LL_PTR]
                     + [_cuda.I] * 7 + [_cuda.P])
    st = _cuda.strides((x, (0, 1, 2)), (dt, (0, 1, 2)), (a, (0, 1, 2)),
                       (Bm, (0, 1, 2)), (Cm, (0, 1, 2)), (y, (0, 1, 2)))
    err = fn(_cuda.DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(),
             a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
             sf.data_ptr(), st, B, H, S, hd, ds, plan.slice_width, int(vec),
             _cuda.stream_ptr(dev))
    _cuda.raise_on(name, err)
    LAUNCHES[name] += 1
    return y, sf
