"""Device and dtype selection for the PyTorch port.

The JAX package needed ``enable_x64``, buffer donation and Pallas compiler
params here (``repro/compat.py``). PyTorch has no counterpart to any of
them: it runs eagerly, updates tensors in place, and takes float64 on
request. What is left is choosing the device and the dtype.

Every entry point of the port takes an explicit ``device`` and defaults to
``"cuda"``. :func:`resolve_device` raises when the card is missing rather
than carrying on on the CPU; the CPU is used only when a caller asks for it
(the tests do).
"""
from __future__ import annotations

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


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name (``"bfloat16"``, ``"float32"``) -> torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"expected one of {sorted(_DTYPES)}") from None
