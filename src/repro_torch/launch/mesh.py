"""Meshes (``repro.launch.mesh``): the production pod and a debug mesh.

``make_production_mesh`` is the JAX package's 256-chip pod, (16, 16)
``("data", "model")``, or two of them, (2, 16, 16) with ``"pod"``. Its
dry-run lays 512 placeholder host devices under XLA
(``--xla_force_host_platform_device_count``) and compiles for them; the
port's counterpart is PyTorch's fake process group, a group of 256 or 512
ranks in one process whose collectives move no data. The dry-run
(``launch/dryrun.py``) runs rank 0's share of the step on it under
``FakeTensorMode``: that is the dry-run's nature, not a fallback, and
nothing is allocated.

``make_debug_mesh`` lays a small mesh over the process group the caller
started (gloo on the CPU in the tests, NCCL on the card).

Both are functions, so importing this module touches no process group.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _fake_world(n: int) -> None:
    """Make the default process group a fake one of ``n`` ranks, with
    this process rank 0 (a fake group of another size is replaced; a real
    group raises)."""
    # registers the "fake" backend
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "the production mesh runs on a fake process group, but a "
                f"{dist.get_backend()!r} group is initialised")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=n)


def make_production_mesh(*, multi_pod: bool = False,
                         shape_override: tuple | None = None) -> DeviceMesh:
    """16x16 (data, model) single pod; 2x16x16 (pod, data, model) for two,
    over a fake process group of as many ranks.

    ``shape_override`` reshapes the SAME pod into a different logical
    factorization (e.g. (32, 8) for archs whose head geometry does not
    divide 16 — granite's 24q/8kv). Perf-iteration knob; the canonical
    meshes remain the defaults.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if shape_override is not None:
        shape = tuple(shape_override)
        axes = ("pod", "data", "model")[-len(shape):]
    _fake_world(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_debug_mesh(data: int = 2, model: int = 2) -> DeviceMesh:
    """A (data, model) mesh over the process group the caller initialised
    (its world size must be ``data * model``): on the card for an NCCL
    group, on the CPU otherwise."""
    if not dist.is_initialized():
        raise RuntimeError("make_debug_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    n = data * model
    if dist.get_world_size() != n:
        raise RuntimeError(f"need {n} ranks, have {dist.get_world_size()}")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, (data, model),
                            mesh_dim_names=("data", "model"))
