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

On the card, :func:`flash_plan` picks the route and the grid from shapes
alone (no tensor is read, so a CUDA graph could capture the call): bf16
at a head width that is a multiple of 16 runs on tensor cores, a CTA of
four warps per 1, 2 or 4 tiles of 16 folded (query, head) rows, the warps
of a row tile splitting each 64-key tile between them; f32 and other
widths take the scalar kernel.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import LAUNCHES, _cuda

NEG_INF = -1e30
#: folded (query, head) rows of a row tile (the mma.sync M)
TC_ROWS = 16
#: warps of a tensor-core CTA and keys of its K/V tiles (``kTcWarps``,
#: ``kTcBK``)
TC_WARPS = 4
TC_BLOCK_K = 64
#: row tiles a CTA may hold (``row_tiles``), most first
ROW_TILE_CHOICES = (4, 2, 1)
#: the plan takes the most row tiles a CTA that still give this many CTAs
#: per SM: sharing K/V tiles among more rows pays once the grid would fill
#: the card about twice over (the row-tile sweep of
#: tools/prefill_ffn_probe.py: 256 CTAs beat 480 or 512 at a padded group
#: of 4 or 8 x 113, one row tile wins at 128-256 CTAs)
CTAS_PER_SM = 1.9
#: query positions of a scalar CTA (before the shared-memory cut)
SCALAR_BQ = 16


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """How a flash call is cut. ``route`` is ``"tensor_core"`` or
    ``"scalar"``. Tensor cores: the ``G * S`` folded rows of each (batch,
    kv head) fall into ``grid_x`` CTAs of ``row_tiles`` tiles of
    ``TC_ROWS`` rows (row ``r`` is query ``r // G`` of head ``r % G``);
    the ``warps // row_tiles`` warps of a row tile split every
    ``block_k``-key tile; ``hd_pad`` is the head width inside the CTA.
    Scalar: ``grid_x`` CTAs of ``rows_per_cta // G`` query positions, all
    G heads each, ``warps`` warps walking the rows."""
    route: str
    G: int
    S: int
    warps: int
    rows_per_cta: int
    grid_x: int
    grid_y: int
    hd_pad: int
    block_k: int
    smem_bytes: int
    row_tiles: int = 1

    @property
    def ctas(self) -> int:
        return self.grid_x * self.grid_y

    def cells(self, x: int) -> list:
        """The (head g, query s) pairs CTA ``x`` of a (batch, kv head)
        computes (grid order; the tensor-core kernel issues the last rows
        first)."""
        if self.route == "tensor_core":
            rows = range(x * self.rows_per_cta,
                         min((x + 1) * self.rows_per_cta, self.G * self.S))
            return [(r % self.G, r // self.G) for r in rows]
        bq = self.rows_per_cta // self.G
        return [(g, s) for g in range(self.G)
                for s in range(x * bq, min((x + 1) * bq, self.S))]


def tc_route_ok(hd: int, dtype) -> bool:
    """Whether the tensor-core kernel takes this head width and dtype."""
    return dtype == torch.bfloat16 and hd % 16 == 0 and 16 <= hd <= 256


def flash_plan(B: int, H: int, G: int, S: int, hd: int, dtype,
               sm_count: int, aligned: bool = True) -> FlashPlan:
    """The launch plan, from shapes alone. ``aligned``: every operand's
    rows start on 16 bytes (the model's views do); otherwise bf16 takes
    the scalar route too.

    Tensor cores: the most row tiles a CTA (4, 2, 1) that still give
    CTAS_PER_SM CTAs an SM, else one: short prompts spread each row
    tile's keys over four warps (qwen3's S = 128, G 2, 8 kv heads: 128
    CTAs), batched ones share each K/V tile among more rows (a padded
    admission group of 8 x 113: 256 CTAs of four row tiles)."""
    if tc_route_ok(hd, dtype) and aligned:
        hd_pad = 64 if hd <= 64 else (128 if hd <= 128 else 256)
        tiles = math.ceil(G * S / TC_ROWS)
        rt = next((r for r in ROW_TILE_CHOICES
                   if math.ceil(tiles / r) * B * H >= CTAS_PER_SM * sm_count),
                  1)
        smem = 2 * (TC_ROWS * rt + 4 * TC_BLOCK_K) * (hd_pad + 8)
        return FlashPlan("tensor_core", G, S, TC_WARPS, TC_ROWS * rt,
                         math.ceil(tiles / rt), B * H, hd_pad, TC_BLOCK_K,
                         smem, rt)
    bq = SCALAR_BQ
    while bq > 1 and _scalar_smem(G * bq, hd) > 200 * 1024:
        bq //= 2
    return FlashPlan("scalar", G, S, 8, G * bq, math.ceil(S / bq), B * H,
                     hd, 32, _scalar_smem(G * bq, hd))


def _scalar_smem(rows: int, hd: int) -> int:
    """csrc/flash_attention.cu smem_bytes (f32 throughout)."""
    return 4 * (2 * rows * hd + 32 * (hd + 1) + 32 * hd + 2 * rows)


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
    dims = ((q, (0, 1, 2, 3)), (k, (0, 1, 2)), (v, (0, 1, 2)),
            (out, (0, 1, 2, 3)))
    plan = flash_plan(B, H, G, S, hd, q.dtype,
                      _cuda.sm_count(dev.index or 0),
                      aligned=_cuda.rows_aligned(*dims))
    st = _cuda.strides(*dims)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), st, B,
            H, G, S, hd, int(causal), -1 if window is None else int(window),
            1.0 / hd ** 0.5)
    if plan.route == "tensor_core":
        fn = _cuda.entry(name, "flash_attention_tc_fwd",
                         [_cuda.P] * 4 + [_cuda.LL_PTR] + [_cuda.I] * 7
                         + [_cuda.F, _cuda.I, _cuda.P])
        err = fn(*args, plan.row_tiles, _cuda.stream_ptr(dev))
    else:
        fn = _cuda.entry(name, "flash_attention_fwd",
                         [_cuda.I] + [_cuda.P] * 4 + [_cuda.LL_PTR]
                         + [_cuda.I] * 7 + [_cuda.F, _cuda.P])
        err = fn(_cuda.DTYPE_CODES[q.dtype], *args, _cuda.stream_ptr(dev))
    _cuda.raise_on(name, err)
    LAUNCHES[name] += 1
    return out
