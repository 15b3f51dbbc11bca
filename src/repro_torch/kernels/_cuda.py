"""Checks and ctypes plumbing shared by the kernel wrappers."""
from __future__ import annotations

import ctypes
import functools

import torch

from ..compat import is_dtensor
from . import _build

#: dtype codes of the C entry points (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def refuse_grad(name: str, tensors) -> None:
    """Raise when autograd would record through kernel ``name``: grad mode
    on and an input that requires grad. The kernels are forward-only, as
    the JAX package's Pallas kernels are (none has a VJP), and a ctypes
    launch leaves its output without a ``grad_fn``, so a backward pass
    through one would silently drop the gradient of everything before
    it. Training runs the reference math (``force_ref``) instead.
    ``tensors``: the inputs (``None`` entries are skipped)."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if t is not None and t.requires_grad:
            raise RuntimeError(
                f"{name}: an input requires grad, but the port's kernels "
                f"are forward-only, as the JAX package's are; run the "
                f"reference math (force_ref=True) to differentiate, or "
                f"call under torch.no_grad()")


def refuse_dtensor(name: str, tensors) -> None:
    """Raise when an input is a DTensor. No kernel is sharded: the sharded
    path runs the reference math (``force_ref=True``), as the JAX
    package's mesh path runs jnp, and a DTensor on the CPU must not
    quietly take the plain version. ``tensors``: the inputs (``None``
    entries are skipped)."""
    for t in tensors:
        if is_dtensor(t):
            raise TypeError(
                f"{name}: got a DTensor; no kernel is sharded, so the "
                f"sharded path runs the reference math (force_ref=True)")


def check(name: str, tensors: dict) -> torch.device:
    """Raise unless every tensor lies on one CUDA device, in one supported
    dtype, with a contiguous last dimension."""
    first = next(iter(tensors.values()))
    dev, dt = first.device, first.dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    if dt not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dt} not supported "
                        f"(float32 or bfloat16)")
    for arg, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, expected {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected {dt}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {arg} needs a contiguous last dim")
    return dev


_entries: dict = {}


def entry(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``fn_name`` of library ``lib_name``, typed (the
    library is built and loaded on first use)."""
    fn = _entries.get((lib_name, fn_name))
    if fn is None:
        fn = getattr(_build.load(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[(lib_name, fn_name)] = fn
    return fn


def stream_ptr(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def strides(*tensors_dims) -> ctypes.Array:
    """Element strides, as the C entry's ``long long`` array."""
    vals = [s for t, dims in tensors_dims for s in (t.stride(d) for d in dims)]
    return (ctypes.c_longlong * len(vals))(*vals)


def rows_aligned(*tensors_dims) -> bool:
    """Whether every tensor starts on 16 bytes and each listed stride is a
    whole number of 16 bytes, so its rows take 16-byte vector copies."""
    for t, dims in tensors_dims:
        if t.data_ptr() % 16 or any(t.stride(d) * t.element_size() % 16
                                    for d in dims):
            return False
    return True


def raise_on(name: str, err: int) -> None:
    """Raise on a non-zero cudaGetLastError() code from a C entry."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {err}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
LL_PTR = ctypes.POINTER(ctypes.c_longlong)
