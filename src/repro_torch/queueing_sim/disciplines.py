"""Service-priority keys for the serving scheduler's admission queue.

Only ``discipline_keys`` for the disciplines the serving launcher offers
(``fifo``, ``sjf``, ``priority``) is ported; the batched DES kernels of
``repro.queueing_sim.disciplines`` wait for a later slice.
"""
from __future__ import annotations

import numpy as np

DISCIPLINES = ("fifo", "sjf", "priority")


def discipline_keys(discipline: str, *, arrivals=None, services=None,
                    accuracy=None):
    """Service-priority keys (lower = served first), any leading shape.

    * ``fifo``: the arrival time.
    * ``sjf``: the service time t_k(l_k) — shortest job first.
    * ``priority``: ``-accuracy / service`` — highest accuracy per second
      of service first.
    """
    if discipline == "fifo":
        return np.asarray(arrivals, dtype=np.float64)
    if discipline == "sjf":
        return np.asarray(services, dtype=np.float64)
    if discipline == "priority":
        s = np.asarray(services, dtype=np.float64)
        return -np.asarray(accuracy, dtype=np.float64) / np.maximum(s, 1e-12)
    raise ValueError(f"discipline {discipline!r} is not ported "
                     f"(expected one of {DISCIPLINES})")
