"""Shared Monte-Carlo statistics helpers for the simulation subsystem.

One home for the seed-axis confidence interval so the sweep layer
(``batched.sweep``), the grid evaluator (``sweeps.evaluate``) and the
discipline ablation all report identically-defined error bars.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ci95"]


def ci95(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """95% normal-approximation half-width over ``axis`` (the seed axis).

    Zero (not NaN) for fewer than two replicates, so single-seed sweeps
    still plot; NaN inputs propagate so masked-unstable cells stay NaN.
    """
    x = np.asarray(x)
    s = x.shape[axis]
    if s < 2:
        return np.zeros(np.delete(x.shape, axis))
    return 1.96 * x.std(axis=axis, ddof=1) / np.sqrt(s)
