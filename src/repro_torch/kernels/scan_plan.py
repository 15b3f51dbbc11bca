"""The scans' launch plan, from shapes alone.

Both scan kernels (``csrc/ssd_scan.cu``, ``csrc/rwkv6_scan.cu``) give each
CTA one (batch, head, channel slice): SSD slices x's ``hd`` channels (the
rows of its ``[hd, ds]`` state, the columns of y), RWKV6 slices v's (the
columns of its ``[hd, hd]`` state and of y). A chunk's ``[Q, Q]`` scores do
not depend on that channel, so every CTA recomputes them itself. The plan
reads no tensor, so a call needs no host sync and can be captured in a
CUDA graph.

Slices are 64, 32 or 16 channels wide (the tensor-core kernels'
templates; none wider than ``hd`` rounded up to 16). The plan takes the
widest that still gives every SM a CTA, else the narrowest: rwkv6-1.6b's
32 heads of 64 take four slices of 16 (128 CTAs on 132 SMs), zamba2-7b's
112 heads two slices of 32 (224 CTAs).
"""
from __future__ import annotations

import dataclasses
import math

#: tokens per chunk of both kernels (``kQ``)
CHUNK = 64
#: channel slice widths, widest first
SLICE_CHOICES = (64, 32, 16)
#: threads of a tensor-core CTA and of a scalar one (8 warps each)
TC_THREADS = 256
SCALAR_THREADS = 256
#: shared memory of an H100 SM that CTAs can hold, and what each reserves
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024
THREADS_PER_SM = 2048


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """How a scan call is cut: ``heads`` (B * H) times ``n_slices`` CTAs,
    each walking ``n_chunks`` chunks of ``chunk`` tokens over the channels
    of its slice (:meth:`channels`). ``route`` is ``"tensor_core"`` (bf16)
    or ``"scalar"`` (f32). ``diag_rows``: RWKV6 on tensor cores, the rows
    of the diagonal blocks that keep a per-pair exp (0 elsewhere)."""
    route: str
    hd: int
    slice_width: int
    n_slices: int
    heads: int
    chunk: int
    n_chunks: int
    smem_bytes: int
    threads: int
    diag_rows: int = 0

    @property
    def ctas(self) -> int:
        return self.heads * self.n_slices

    def channels(self, s: int) -> range:
        """The channels slice ``s`` owns."""
        return range(s * self.slice_width,
                     min((s + 1) * self.slice_width, self.hd))

    @property
    def ctas_per_sm(self) -> int:
        """CTAs an SM can hold at once, by shared memory and threads."""
        return min(SMEM_PER_SM // (self.smem_bytes + SMEM_RESERVED),
                   THREADS_PER_SM // self.threads)

    def fields(self) -> dict:
        """The plan as a row of numbers (chip_smoke.py, the probe)."""
        return {"route": self.route, "slice_width": self.slice_width,
                "n_slices": self.n_slices, "ctas": self.ctas,
                "chunk": self.chunk, "n_chunks": self.n_chunks,
                "smem_bytes": self.smem_bytes,
                **({"diag_rows": self.diag_rows} if self.diag_rows else {})}


def slice_width(heads: int, hd: int, sm_count: int) -> int:
    """The widest slice whose grid gives every SM a CTA, else the
    narrowest (see the module docstring)."""
    widths = [p for p in SLICE_CHOICES if p <= 16 * math.ceil(hd / 16)]
    for p in widths:
        if heads * math.ceil(hd / p) >= sm_count:
            return p
    return widths[-1]


def make_plan(route: str, heads: int, S: int, hd: int, width: int,
              smem_bytes: int, diag_rows: int = 0) -> ScanPlan:
    return ScanPlan(route, hd, width, math.ceil(hd / width), heads, CHUNK,
                    math.ceil(S / CHUNK), smem_bytes,
                    TC_THREADS if route == "tensor_core" else SCALAR_THREADS,
                    diag_rows)
