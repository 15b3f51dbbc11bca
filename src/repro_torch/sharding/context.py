"""Ambient mesh context (``repro.sharding.context``).

Model code is mesh-agnostic except where locality matters: MoE routing
must happen per data shard, since a global sort or gather over the
flattened token axis would move every shard's activations. The
launchers (the dry-run, the distribution phase of ``chip_smoke.py``)
install the mesh here; the MoE layer picks it up and runs its dispatch
on local shards (``local_map``).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or ``None``.
While a mesh is installed, DTensor's implicit replication is on: a plain
tensor that the model makes (positions, masks, zeros) meets the sharded
ones as a replicated DTensor, as a constant is replicated under GSPMD.
"""
from __future__ import annotations

import contextlib
from typing import Optional

_CURRENT: list = []


def get_mesh():
    """The installed ``DeviceMesh``, or None."""
    return _CURRENT[-1][0] if _CURRENT else None


def get_options():
    """Distribution options installed alongside the mesh (or None)."""
    return _CURRENT[-1][1] if _CURRENT else None


@contextlib.contextmanager
def use_mesh(mesh: Optional[object], options=None):
    _CURRENT.append((mesh, options))
    try:
        if mesh is None:
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
    finally:
        _CURRENT.pop()
