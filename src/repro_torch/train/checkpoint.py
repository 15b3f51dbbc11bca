"""Checkpoints in the JAX package's on-disk layout (``repro.train.checkpoint``).

A checkpoint directory holds ``meta.json`` (leaf count, step, dtypes,
shapes, and under ``treedef`` the port's key paths, which the JAX package
writes for information only) and ``leaves.msgpack``: one MessagePack map
``{"i", "dtype", "shape", "data"}`` a leaf, its raw bytes in ``data``.
Leaves go in JAX's ``tree_flatten`` order (``train/tree.py``), so a
checkpoint written by either package restores in the other. bf16 leaves
carry the dtype ``"bfloat16"``, as ``ml_dtypes`` names it, and their
16-bit patterns. The codec is the package's own (``train/_msgpack.py``).
"""
from __future__ import annotations

import json
import pathlib
from typing import Any

import numpy as np
import torch

from ..compat import is_dtensor
from . import _msgpack
from .tree import tree_items, tree_leaves, tree_unflatten


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(np.dtype(str(t.dtype).removeprefix("torch.")))


def _host_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _from_bytes(data: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(data, dtype=np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(arr.copy())


def save_checkpoint(path: str, tree: Any, step: int | None = None) -> None:
    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    items = tree_items(tree)
    leaves = [leaf for _, leaf in items]
    meta = {
        "treedef": [key for key, _ in items],
        "n_leaves": len(leaves),
        "step": step,
        "dtypes": [_dtype_name(t) for t in leaves],
        "shapes": [list(t.shape) for t in leaves],
    }
    (p / "meta.json").write_text(json.dumps(meta))
    with open(p / "leaves.msgpack", "wb") as f:
        for i, leaf in enumerate(leaves):
            f.write(_msgpack.packb({
                "i": i,
                "dtype": _dtype_name(leaf),
                "shape": list(leaf.shape),
                "data": _host_bytes(leaf),
            }))


def restore_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``: each leaf on its ``like``
    leaf's device, in its dtype and layout, in memory PyTorch allocated
    (a numpy buffer's alignment could change a vectorised reduction's
    order, and so a resumed run's last bits). Where a ``like`` leaf is a
    DTensor, the restored leaf is one too, on its mesh and placements
    (each rank reads the whole leaf and keeps its shard), as the JAX
    package puts each leaf on its ``like`` leaf's sharding."""
    p = pathlib.Path(path)
    leaves_like = tree_leaves(like)
    meta = json.loads((p / "meta.json").read_text())
    if meta["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves; target structure "
            f"has {len(leaves_like)}")
    out = [None] * len(leaves_like)
    with open(p / "leaves.msgpack", "rb") as f:
        for item in _msgpack.unpack_stream(f):
            i = item["i"]
            t = _from_bytes(item["data"], item["dtype"], item["shape"])
            ref = leaves_like[i]
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: shape {tuple(t.shape)} != "
                                 f"{tuple(ref.shape)}")
            if is_dtensor(ref):
                from torch.distributed.tensor import distribute_tensor
                mesh = ref.device_mesh
                full = torch.empty(t.shape, dtype=ref.dtype,
                                   device=mesh.device_type).copy_(t)
                out[i] = distribute_tensor(full, mesh, ref.placements,
                                           src_data_rank=None)
            else:
                out[i] = torch.empty_like(ref).copy_(t)
    return tree_unflatten(like, out)


def checkpoint_step(path: str) -> int | None:
    p = pathlib.Path(path) / "meta.json"
    if not p.exists():
        return None
    return json.loads(p.read_text()).get("step")
