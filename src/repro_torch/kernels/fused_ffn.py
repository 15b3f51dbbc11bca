"""Fused SwiGLU FFN: the Hopper kernel wrapper and its plain version.

Counterpart of ``repro.kernels.fused_ffn.fused_ffn`` (Pallas TPU); the CUDA
source is ``csrc/fused_ffn.cu``. Layouts are the TPU kernel's:

    x  [E, T, d]      wg, wu [E, d, f]      wd [E, f, d]      y [E, T, d]

all contiguous. ``h = silu(x wg) * (x wu)`` is formed in f32 and rounded to
the input dtype before the down projection, as in the TPU kernel.

``rows`` (optional, the MoE's dispatch buffer): an int32 ``[E]`` tensor
on x's device, the live rows of each expert. Rows ``>= rows[e]`` of
expert ``e`` need no output: the kernel skips every row tile that starts
there, so an expert that no row was sent to costs no weight bytes, and
leaves such rows of ``y`` unwritten; the caller reads none of them. The
counts stay on the device (no host read, so the call can be captured in a
CUDA graph), and the plan is the same as without them. ``rows=None``
launches exactly as before. The plain version computes every row.

On the card, :func:`ffn_plan` picks the route and the tiling from shapes
alone (no tensor is read, so a CUDA graph could capture the call): bf16
runs two tensor-core GEMMs (gate/up with the SwiGLU epilogue into a bf16
``h`` scratch, then down), in 16-row tiles while ``T <= DECODE_MAX_T`` (the
decode regime) and 64-row tiles beyond (prefill), the reduction split over
CTAs where the output tiles alone would leave SMs idle; f32 takes the
scalar kernel.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import LAUNCHES, _cuda

_BF = 32         # d_ff columns per chunk (csrc/fused_ffn.cu kBF)
_PARTS = 8       # warps splitting the d reduction (csrc/fused_ffn.cu kParts)
_SMEM_MAX = 227 * 1024
#: tensor-core tiles (csrc/fused_ffn.cu kBN, kBKt, kStages, kLD)
TILE_N = 64
TILE_K = 64
STAGES = 4
_LD = 72
#: the decode regime's row tile covers T up to this; prefill tiles are 64
DECODE_MAX_T = 16
#: most CTAs one output tile's reduction is split over
SPLIT_MAX = 16
#: the f32 partials of a split reduction stay within this share of the
#: weight bytes the GEMM streams
PARTIAL_SHARE = 0.25
#: the down GEMM launches as a programmatic dependent of the gate/up GEMM
#: in the decode regime while the call's weights stay under this many
#: bytes: there the launch gap it hides is a large share of the call
PDL_MAX_WEIGHT_BYTES = 64 * 2 ** 20


@dataclasses.dataclass(frozen=True)
class FfnPlan:
    """How an FFN call is cut. ``route`` is ``"tensor_core"`` or
    ``"scalar"``; ``regime`` ``"decode"`` (16-row tiles), ``"prefill"``
    (64-row tiles) or ``"scalar"``. Tensor cores: two GEMMs, gate/up over
    ``up_tiles`` output tiles of ``bm`` x ``TILE_N`` (h's rows x d_ff
    columns) with the d reduction split ``ks_up`` ways, then down over
    ``down_tiles`` (rows x d columns) with d_ff split ``ks_down`` ways.
    ``pdl``: the down GEMM launches as a programmatic dependent of the
    gate/up GEMM and prefetches its weights while that one runs.
    Scalar: ``bt`` rows a CTA, ``n_split`` shares of the d_ff chunks."""
    route: str
    regime: str
    bm: int
    m_tiles: int
    up_tiles: int
    down_tiles: int
    ks_up: int
    ks_down: int
    smem_up: int
    smem_down: int
    h_bytes: int
    scratch_bytes: int
    counters: int
    pdl: bool = False
    bt: int = 0
    n_split: int = 0

    @property
    def grid_up(self) -> int:
        return self.up_tiles * self.ks_up

    @property
    def grid_down(self) -> int:
        return self.down_tiles * self.ks_down


def split_range(ks: int, k_tiles: int, split: int) -> range:
    """The reduction tiles split ``split`` of ``ks`` walks
    (csrc/fused_ffn.cu: kt0, kt1)."""
    return range(split * k_tiles // ks, (split + 1) * k_tiles // ks)


def _splits(tiles: int, k_tiles: int, target: int, partial_bytes: int,
            weight_bytes: int) -> int:
    """Reduction splits of one GEMM: enough that the grid reaches
    ``target`` CTAs, at most SPLIT_MAX and the reduction's tiles, and
    partials within PARTIAL_SHARE of the weights."""
    if tiles >= target:
        return 1
    cap = int(PARTIAL_SHARE * weight_bytes // partial_bytes)
    return max(1, min(math.ceil(target / tiles), SPLIT_MAX, k_tiles, cap))


def tc_route_ok(d: int, f: int, dtype) -> bool:
    """Whether the tensor-core kernels take these widths and dtype."""
    return dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0


def ffn_plan(E: int, T: int, d: int, f: int, dtype, sm_count: int,
             aligned: bool = True) -> FfnPlan:
    """The launch plan, from shapes alone. ``aligned``: every operand
    starts on 16 bytes (the model's weights and activations do);
    otherwise bf16 takes the scalar route too.

    The gate/up GEMM aims at one CTA per SM, the down GEMM at two: its CTA
    streams one weight tile a stage where a gate/up CTA streams two, so
    twice the CTAs keep the same bytes in flight (the splits swept in
    ``tools/prefill_ffn_probe.py``)."""
    el = torch.finfo(dtype).bits // 8
    if not (tc_route_ok(d, f, dtype) and aligned):
        bt, n_split = _launch_shape(T, E, f, sm_count, d)
        return FfnPlan("scalar", "scalar", bt, math.ceil(T / bt), 0, 0, 1,
                       1, _smem_bytes(bt, d), 0, 0,
                       4 * n_split * E * T * d, 0, bt=bt, n_split=n_split)
    bm = 16 if T <= DECODE_MAX_T else 64
    m_tiles = math.ceil(T / bm)
    up_tiles = E * m_tiles * math.ceil(f / TILE_N)
    down_tiles = E * m_tiles * math.ceil(d / TILE_N)
    ks_up = _splits(up_tiles, math.ceil(d / TILE_K), sm_count,
                    2 * E * T * f * 4, 2 * E * d * f * el)
    ks_down = _splits(down_tiles, math.ceil(f / TILE_K), 2 * sm_count,
                      E * T * d * 4, E * d * f * el)
    smem = [2 * STAGES * _LD * (bm + nb * TILE_K) for nb in (2, 1)]
    return FfnPlan("tensor_core", "decode" if bm == 16 else "prefill", bm,
                   m_tiles, up_tiles, down_tiles, ks_up, ks_down, *smem,
                   E * T * f * el, scratch_bytes(E, T, d, f, ks_up, ks_down),
                   up_tiles + down_tiles,
                   pdl=bm == 16 and 3 * E * d * f * el <= PDL_MAX_WEIGHT_BYTES)


def scratch_bytes(E: int, T: int, d: int, f: int, ks_up: int,
                  ks_down: int) -> int:
    """The f32 partials of the split reductions (the two GEMMs run one
    after the other and share the buffer)."""
    up = 2 * ks_up * E * T * f * 4 if ks_up > 1 else 0
    down = ks_down * E * T * d * 4 if ks_down > 1 else 0
    return max(up, down)


def fused_ffn_plain(x, wg, wu, wd, rows=None) -> torch.Tensor:
    """Plain PyTorch version with the kernel's arithmetic. It computes
    every row, so ``rows`` is taken and not read."""
    g = torch.matmul(x.float(), wg.float())
    u = torch.matmul(x.float(), wu.float())
    h = (torch.nn.functional.silu(g) * u).to(x.dtype)
    return torch.matmul(h.float(), wd.float()).to(x.dtype)


def fused_ffn(x, wg, wu, wd, rows=None) -> torch.Tensor:
    """SwiGLU FFN batched over E; ``rows``: live rows of each expert. A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    _cuda.refuse_dtensor("fused_ffn", (x, wg, wu, wd, rows))
    if x.device.type == "cpu":
        return fused_ffn_plain(x, wg, wu, wd, rows)
    return _launch(x, wg, wu, wd, rows)


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


def _launch(x, wg, wu, wd, rows=None):
    name = "fused_ffn"
    _cuda.refuse_grad(name, (x, wg, wu, wd, rows))
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
    if rows is not None and (rows.device != dev or rows.dtype != torch.int32
                             or tuple(rows.shape) != (E,)
                             or not rows.is_contiguous()):
        raise ValueError(f"{name}: rows must be a contiguous int32 [{E}] "
                         f"tensor on {dev}, got {rows.dtype} "
                         f"{tuple(rows.shape)} on {rows.device}")
    rows_ptr = None if rows is None else rows.data_ptr()
    aligned = _cuda.rows_aligned(*((t, ()) for t in (x, wg, wu, wd)))
    plan = ffn_plan(E, T, d, f, x.dtype, _cuda.sm_count(dev.index or 0),
                    aligned=aligned)
    y = torch.empty_like(x)
    scratch = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                          device=dev)
    if plan.route == "tensor_core":
        h = torch.empty((E, T, f), dtype=x.dtype, device=dev)
        fn = _cuda.entry(name, "fused_ffn_tc_fwd",
                         [_cuda.P] * 9 + [_cuda.I] * 8 + [_cuda.P])
        err = fn(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                 y.data_ptr(), h.data_ptr(), scratch.data_ptr(),
                 _counters(dev, plan.counters).data_ptr(), rows_ptr, E, T, d,
                 f, plan.bm, plan.ks_up, plan.ks_down, int(plan.pdl),
                 _cuda.stream_ptr(dev))
    else:
        fn = _cuda.entry(name, "fused_ffn_fwd",
                         [_cuda.I] + [_cuda.P] * 7 + [_cuda.I] * 6
                         + [_cuda.P])
        err = fn(_cuda.DTYPE_CODES[x.dtype], x.data_ptr(), wg.data_ptr(),
                 wu.data_ptr(), wd.data_ptr(), rows_ptr, y.data_ptr(),
                 scratch.data_ptr(), E, T, d, f, plan.bt, plan.n_split,
                 _cuda.stream_ptr(dev))
    _cuda.raise_on(name, err)
    LAUNCHES[name] += 1
    return y


_COUNTERS: dict = {}


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    """The split reductions' per-tile arrival counters: zero between calls
    (the last CTA of a tile resets its own), so one buffer per device
    serves every call and every replay of a captured graph. Allocated on
    first need (a graph capture must not be the first call); a larger
    call allocates a larger buffer and the old one is kept, since a graph
    captured before may still point at it."""
    bufs = _COUNTERS.setdefault(dev, [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 4096), dtype=torch.int32, device=dev))
    return bufs[-1]
