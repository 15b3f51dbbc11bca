"""RWKV6 wkv chunked scan: the Hopper kernel wrapper and its plain version.

Counterpart of ``repro.kernels.rwkv6_scan.rwkv6_scan`` (Pallas TPU); the
CUDA source is ``csrc/rwkv6_scan.cu``. Layouts split the TPU kernel's
leading ``BH`` into batch and head, so the model's ``[B, S, nh, hd]``
projections pass as strided views without a copy:

    r, k, v  [B, H, S, hd]   f32 or bf16, any strides, hd contiguous
    la       [B, H, S, hd]   f32 log decay (< 0), any strides, hd contiguous
    u        [B, H, hd]      f32 bonus, any strides (the model passes its
                             [H, hd] with a batch stride of 0)
    y        [B, H, S, hd]   r's dtype; the kernel's is a view of a
                             [B, S, H, hd] buffer (the model's layout)
    s_final  [B, H, hd, hd]  f32

The TPU layout ``[BH, S, hd]`` is the case ``H = 1``. The function, from
a zero state:

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(exp(la_t)) S_{t-1} + k_t v_t^T

Both versions take it in chunks of ``CHUNK`` tokens with the exponent
formed per pair, ``exp(e_i - c_j)``, where ``c`` is the chunk's inclusive
and ``e`` its exclusive cumulative log decay. Every such exponent is
``<= 0``, so no decay overflows: the TPU kernel's factored
``exp(cs_i - la_i) * exp(-cs_j)`` overflows f32 once a chunk's cumulative
decay on a channel passes about -88. Where that form is finite the two
compute the same function. Any S is taken; the chunk length does not
change the result.

On the card, :func:`rwkv6_plan` splits each head's value channels over
CTAs from shapes alone (``scan_plan``); bf16 runs on tensor cores with
the off-diagonal pairs factored at sub-block boundaries (every factor
``<= 1``, see ``csrc/rwkv6_scan.cu``), f32 on scalar FMAs.
"""
from __future__ import annotations

import torch

from . import LAUNCHES, _cuda
from ..compat import acc
from .scan_plan import CHUNK, ScanPlan, make_plan, slice_width

MAX_HD = 64      # head dims the kernel takes (csrc/rwkv6_scan.cu kMaxHD)
#: hd padded inside a tensor-core CTA (csrc/rwkv6_scan.cu kHDP)
HD_PAD = 64
#: rows of the diagonal blocks whose pairs keep a per-pair exp (8 or 16;
#: the rest of the chunk's pairs are factored at block boundaries)
DIAG_ROWS = 8


def tc_smem_bytes(width: int) -> int:
    """csrc/rwkv6_scan.cu tc_smem_bytes<P>: the r, k, v, la ring, the
    state's bf16 copy, the chunk's decay-factored operand tiles (464 rows),
    u and the per-pair dots."""
    return (2 * (4 * CHUNK * (HD_PAD + 8) + 3 * CHUNK * (width + 8)
                 + 464 * (HD_PAD + 8))
            + 4 * (2 * CHUNK * (HD_PAD + 4) + HD_PAD + 4 * 256))


def scalar_smem_bytes(hd: int, width: int) -> int:
    """csrc/rwkv6_scan.cu scalar_smem_bytes (f32 throughout)."""
    return 4 * (4 * CHUNK * (hd + 1) + CHUNK * (width + 1)
                + CHUNK * (CHUNK + 1) + hd * (width + 1) + hd)


def rwkv6_plan(B: int, H: int, S: int, hd: int, dtype,
               sm_count: int) -> ScanPlan:
    """The launch plan, from shapes alone: bf16 on tensor cores, f32 on
    scalar FMAs, each head's value channels in slices (``scan_plan``)."""
    width = slice_width(B * H, hd, sm_count)
    if dtype == torch.bfloat16:
        return make_plan("tensor_core", B * H, S, hd, width,
                         tc_smem_bytes(width), DIAG_ROWS)
    return make_plan("scalar", B * H, S, hd, width,
                     scalar_smem_bytes(hd, width))


def rwkv6_scan_plain(r, k, v, la, u, chunk: int = CHUNK):
    """Plain PyTorch version: the kernel's chunked arithmetic in f32 (in
    f64 for f64 inputs), y rounded to r's dtype at the end."""
    B, H, S, hd = r.shape
    rf, kf, vf, laf = acc(r), acc(k), acc(v), acc(la)
    uf = acc(u).expand(B, H, hd)
    s = torch.zeros(B, H, hd, hd, dtype=rf.dtype, device=r.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        rq, kq, vq, lq = rf[:, :, sl], kf[:, :, sl], vf[:, :, sl], laf[:, :, sl]
        Q = rq.shape[2]
        c = torch.cumsum(lq, dim=2)                      # inclusive
        e = torch.cat([torch.zeros_like(c[:, :, :1]), c[:, :, :-1]], dim=2)
        strict = torch.ones(Q, Q, dtype=torch.bool,
                            device=r.device).tril(-1)[:, :, None]
        # exp only where j < i: the exponent is <= 0 there, -inf elsewhere
        w = torch.exp(torch.where(strict, e[:, :, :, None] - c[:, :, None],
                                  torch.full((), -torch.inf,
                                             device=r.device)))
        att = torch.einsum("bhit,bhjt,bhijt->bhij", rq, kq, w)
        diag = (rq * uf[:, :, None] * kq).sum(-1)
        y = torch.matmul(att, vq) + diag[..., None] * vq \
            + torch.matmul(rq * torch.exp(e), s)
        clast = c[:, :, -1]                              # [B, H, hd]
        kst = kq * torch.exp(clast[:, :, None] - c)
        s = torch.exp(clast)[..., None] * s + torch.matmul(
            kst.transpose(-1, -2), vq)
        ys.append(y)
    return torch.cat(ys, dim=2).to(r.dtype), s


def rwkv6_scan(r, k, v, la, u):
    """RWKV6 wkv scan; see the module docstring for layouts.

    Returns ``(y, s_final)``. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises.
    """
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, la, u)
    return _launch(r, k, v, la, u)


def _launch(r, k, v, la, u):
    name = "rwkv6_scan"
    dev = _cuda.check(name, {"r": r, "k": k, "v": v})
    B, H, S, hd = r.shape
    for arg, t in (("k", k), ("v", v), ("la", la)):
        if tuple(t.shape) != (B, H, S, hd):
            raise ValueError(f"{name}: {arg} shape {tuple(t.shape)} does not "
                             f"match r {tuple(r.shape)}")
    if tuple(u.shape) != (B, H, hd):
        raise ValueError(f"{name}: u shape {tuple(u.shape)}, expected "
                         f"{(B, H, hd)}")
    for arg, t in (("la", la), ("u", u)):
        if t.dtype != torch.float32 or t.device != dev or t.stride(-1) != 1:
            raise ValueError(f"{name}: {arg} must be float32 on {dev} with a "
                             f"contiguous last dim")
    if not 1 <= hd <= MAX_HD or S < 1:
        raise ValueError(f"{name}: head_dim {hd} (1..{MAX_HD}) and S {S} "
                         f"(>= 1) not supported")
    y = torch.empty((B, S, H, hd), dtype=r.dtype,
                    device=dev).permute(0, 2, 1, 3)
    sf = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    plan = rwkv6_plan(B, H, S, hd, r.dtype, _cuda.sm_count(dev.index or 0))
    dims = (0, 1, 2)
    vec = hd % 8 == 0 and _cuda.rows_aligned((r, dims), (k, dims), (v, dims),
                                             (la, dims))
    fn = _cuda.entry(name, "rwkv6_scan_fwd",
                     [_cuda.I] + [_cuda.P] * 7 + [_cuda.LL_PTR]
                     + [_cuda.I] * 7 + [_cuda.P])
    st = _cuda.strides((r, dims), (k, dims), (v, dims), (la, dims),
                       (u, (0, 1)), (y, dims))
    err = fn(_cuda.DTYPE_CODES[r.dtype], r.data_ptr(), k.data_ptr(),
             v.data_ptr(), la.data_ptr(), u.data_ptr(), y.data_ptr(),
             sf.data_ptr(), st, B, H, S, hd, plan.slice_width,
             plan.diag_rows, int(vec), _cuda.stream_ptr(dev))
    _cuda.raise_on(name, err)
    LAUNCHES[name] += 1
    return y, sf
