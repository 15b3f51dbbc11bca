"""Principal-branch Lambert-W in PyTorch.

The fixed-point update (eq 22) needs W0(z) for z = b_k L_k exp(-b_k K_k) > 0.
W0 for z >= 0 comes from a log-based initial guess followed by a fixed
number of Newton iterations on the log-space residual
f(w) = w + log(w) - log(z), which stays finite for the huge z (1e100+) the
paper's instances produce. The JAX package ran the same iteration as a
``lax.scan`` with a custom JVP; here it is a fixed-count loop, and no JVP
is needed because the solvers use the analytic ``objective.grad``.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

_NEWTON_ITERS = 40


def lambertw0(z: Tensor) -> Tensor:
    """Principal branch W0(z) for z >= 0 (elementwise)."""
    z = torch.as_tensor(z)
    if not z.is_floating_point():
        z = z.to(torch.get_default_dtype())
    eps = torch.finfo(z.dtype).tiny
    logz = torch.log(torch.clamp(z, min=eps))

    # Initial guess: series for small z, log(1+z) mid-range, asymptotic
    # log z - log log z for large z (where log log z is well defined).
    w_small = z * (1.0 - z)
    w_mid = torch.log1p(z)
    w_big = logz - torch.log(torch.clamp(logz, min=1.0))
    w = torch.where(z < 0.3, torch.clamp(w_small, min=0.0),
                    torch.where(z < 20.0, w_mid, w_big))

    for _ in range(_NEWTON_ITERS):
        # Newton on f(w) = w + log w - log z (valid for w > 0); for small w
        # fall back to the direct form w e^w - z.
        safe_w = torch.clamp(w, min=eps)
        step_log = safe_w * (logz - safe_w - torch.log(safe_w)) / (1.0 + safe_w)
        ew = torch.exp(torch.clamp(w, max=50.0))
        step_direct = -(w * ew - z) / torch.clamp(ew * (1.0 + w), min=eps)
        step = torch.where(w > 1e-3, step_log, step_direct)
        # W(z) > 0 for z > 0: clamp so a bad step can never exit the domain
        w = torch.clamp(w + step, min=0.0)
    return torch.where(z == 0.0, torch.zeros_like(w), w)
