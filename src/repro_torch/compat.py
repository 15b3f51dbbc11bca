"""Device and dtype selection for the PyTorch port.

The JAX package needed ``enable_x64``, buffer donation and Pallas compiler
params here (``repro/compat.py``). PyTorch has no counterpart to any of
them: it runs eagerly, updates tensors in place, and takes float64 on
request. What is left is choosing the device and the dtype.

Every entry point of the port takes an explicit ``device`` and defaults to
``"cuda"``. :func:`resolve_device` raises when the card is missing rather
than carrying on on the CPU; the CPU is used only when a caller asks for it
(the tests do).

:func:`cap_xdist_threads` keeps parallel test workers from oversubscribing
the host's cores.
"""
from __future__ import annotations

import functools
import os

import torch

DEFAULT_DEVICE = "cuda"

#: control-plane precision (the JAX package ran its solvers under x64)
CONTROL_DTYPE = torch.float64

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def require_cuda() -> None:
    """Raise unless a CUDA device is visible to PyTorch."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "False); pass device='cpu' explicitly to run on the CPU")


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA request needs a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    return dev


def acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the dtype the models compute in: f32 for bf16 and f32
    tensors, as in the JAX package, and f64 for f64 ones, which only a run
    that measures f32 rounding against an f64 evaluation feeds them."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def cap_xdist_threads() -> None:
    """Cap torch's intra-op threads at one in a pytest-xdist worker.

    Each worker would otherwise start one thread per core, so ``-n 6`` on
    eight cores runs some fifty threads on eight cores, and the port's
    test files take several times longer than alone. Outside xdist
    (``PYTEST_XDIST_WORKER`` unset) nothing changes. The port's test
    modules call this at import.
    """
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _dtensor_class():
    if not torch.distributed.is_available():
        return None
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (``torch.distributed.tensor``): a tensor
    of the sharded path, laid out over a mesh."""
    cls = _dtensor_class()
    return cls is not None and isinstance(t, cls)


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name (``"bfloat16"``, ``"float32"``) -> torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"expected one of {sorted(_DTYPES)}") from None
