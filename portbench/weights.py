"""Random weights drawn on the card from the run's seed.

Each leaf of a model's parameter tree is drawn as ``N(0, 1) * std`` in
float32 by a ``torch.Generator`` on the device and cast to the served
dtype; a leaf stacked on a layer axis is drawn one layer at a time, each
from a seed of its own (``(seed, leaf, layer)``), so that the reference
can draw any single layer again, bit for bit, without the program's
copy. A leaf with ``std`` None is all ones (a norm's scale).

The family module (``families/<family>.py``) lists the leaves; this
module imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Leaf:
    path: tuple                 # keys into the parameter tree
    shape: tuple                # one layer's shape
    std: Optional[float]        # None: ones
    stacked: bool               # stacked on the layer axis


def leaf_seed(seed: int, index: int, layer: int) -> int:
    ss = np.random.SeedSequence([int(seed), int(index), int(layer) + 1])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def draw(leaf: Leaf, index: int, seed: int, layer: int, dtype,
         device) -> torch.Tensor:
    """One layer of ``leaf`` (``layer`` -1 for an unstacked leaf), in
    ``dtype``: the served values, whatever dtype they are handed on in."""
    if leaf.std is None:
        return torch.ones(leaf.shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(
        leaf_seed(seed, index, layer))
    x = torch.randn(leaf.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(leaf.std).to(dtype)


def build(leaves, n_layers: int, seed: int, dtype, device) -> dict:
    """The whole tree, every stacked leaf ``[n_layers, *shape]``."""
    tree: dict = {}
    for i, leaf in enumerate(leaves):
        if leaf.stacked:
            t = torch.empty((n_layers, *leaf.shape), dtype=dtype,
                            device=device)
            for layer in range(n_layers):
                t[layer] = draw(leaf, i, seed, layer, dtype, device)
        else:
            t = draw(leaf, i, seed, -1, dtype, device)
        node = tree
        for key in leaf.path[:-1]:
            node = node.setdefault(key, {})
        node[leaf.path[-1]] = t
    return tree


def layer(leaves, seed: int, layer_idx: int, dtype, device,
          served_dtype) -> dict:
    """One layer's stacked leaves by path, drawn again: the served values
    (``served_dtype``) handed on in ``dtype``."""
    return {leaf.path: draw(leaf, i, seed, layer_idx, served_dtype,
                            device).to(dtype)
            for i, leaf in enumerate(leaves) if leaf.stacked}


def unstacked(leaves, seed: int, dtype, device, served_dtype) -> dict:
    return {leaf.path: draw(leaf, i, seed, -1, served_dtype,
                            device).to(dtype)
            for i, leaf in enumerate(leaves) if not leaf.stacked}
