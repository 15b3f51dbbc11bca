"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each kernel module (``flash_attention``, ``decode_attention`` with the
slot and the paged kernel, ``fused_ffn``, ``rwkv6_scan``, ``ssd_scan``)
holds wrappers that launch the
CUDA kernels built from ``repro_torch/csrc`` for a CUDA tensor, and each
kernel's plain PyTorch version, which the wrapper takes only for a CPU
tensor. ``ops`` adapts the
model's layouts to the kernels'; ``ref`` holds the JAX package's oracles;
``scan_plan`` the two scans' shape-only launch plan.

``LAUNCHES`` counts kernel launches per kernel name: each wrapper adds one
where it launches its kernel, and nowhere else, so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

import collections

LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    LAUNCHES.clear()
