"""Mamba2 block with the SSD scan.

The port of ``repro.models.mamba2``. Recurrence per head h (scalar decay
a_t = exp(A dt_t), A < 0):

    S_t = a_t S_{t-1} + dt_t x_t B_t^T        S in R^{hd x ds}
    y_t = S_t C_t + D x_t

Prefill (any batch: the continuous engine admits groups of equal-length
prompts, one final state and conv tail per row) runs the scan through
``kernels.ops.ssd_scan`` (the Hopper kernel
on a CUDA device, its plain version on the CPU, the sequential oracle
under ``force_ref``) where the JAX package ran its own jnp chunked scan;
both compute the same function. ``D x`` stays outside the scan. Decode is
the single-step recurrence against a ``[B, nh, hd, ds]`` state. ``A_log``,
``D`` and ``dt_bias`` stay f32 in a bf16 model.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..compat import is_dtensor
from ..kernels import ops as kops
from .config import ModelConfig
from .layers import _he, on_local_heads

Tensor = torch.Tensor


class MambaCache(NamedTuple):
    """Recurrent decode state; the model stacks each leaf on leading layer
    axes and updates it in place."""

    conv_x: Tensor   # [..., B, d_conv - 1, d_in]  trailing conv inputs
    conv_bc: Tensor  # [..., B, d_conv - 1, 2*ds]  trailing B/C conv inputs
    ssd: Tensor      # [..., B, nh, hd, ds] f32 recurrent state
    length: int      # tokens seen, host bookkeeping: no decode op reads
                     # it, and a replayed CUDA graph step does not advance it


def dims(cfg: ModelConfig):
    d_in = cfg.ssm.expand * cfg.d_model
    return d_in, d_in // cfg.ssm.head_dim, cfg.ssm.head_dim, cfg.ssm.d_state


def init_mamba2(cfg: ModelConfig, gen: torch.Generator, lead: tuple) -> dict:
    d, K = cfg.d_model, cfg.ssm.d_conv
    d_in, nh, hd, ds = dims(cfg)
    dt, dev = cfg.tdtype, gen.device

    def full(shape, value, dtype=dt):
        return torch.full(lead + shape, value, dtype=dtype, device=dev)
    return {
        "z_proj": _he(gen, lead + (d, d_in), dt, fan_in=d),
        "x_proj": _he(gen, lead + (d, d_in), dt, fan_in=d),
        "bc_proj": _he(gen, lead + (d, 2 * ds), dt, fan_in=d),
        "dt_proj": _he(gen, lead + (d, nh), dt, fan_in=d),
        "conv_x": _he(gen, lead + (K, d_in), dt, fan_in=K),
        "conv_bc": _he(gen, lead + (K, 2 * ds), dt, fan_in=K),
        "conv_b_x": full((d_in,), 0.0),
        "conv_b_bc": full((2 * ds,), 0.0),
        "A_log": full((nh,), 0.0, torch.float32),      # A = -exp(A_log)
        "D": full((nh,), 1.0, torch.float32),
        "dt_bias": full((nh,), -2.0, torch.float32),
        "norm": full((d_in,), 1.0),
        "out_proj": _he(gen, lead + (d_in, d), dt, fan_in=d_in),
    }


def _split_proj(cfg: ModelConfig, p: dict, x: Tensor):
    ds = cfg.ssm.d_state
    z = torch.matmul(x, p["z_proj"])
    xi = torch.matmul(x, p["x_proj"])
    bc = torch.matmul(x, p["bc_proj"])
    dt = torch.matmul(x, p["dt_proj"])
    return z, xi, bc[..., :ds], bc[..., ds:], dt


def _conv_full(w: Tensor, b: Tensor, u: Tensor) -> Tensor:
    """Causal depthwise conv over [B,S,C] with width K, then silu."""
    K, S = w.shape[0], u.shape[1]
    pad = torch.nn.functional.pad(u, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(K))
    return torch.nn.functional.silu((out + b).float()).to(u.dtype)


def _gated_norm(cfg: ModelConfig, p: dict, y: Tensor, z: Tensor) -> Tensor:
    yf = (y * torch.nn.functional.silu(z.float()).to(y.dtype)).float()
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6)
    return (yf * p["norm"].float()).to(y.dtype)


def _tail(u: Tensor, n: int) -> Tensor:
    """The last ``n`` rows of [B,S,C], zero rows in front when S < n (the
    conv's own zero padding)."""
    return torch.nn.functional.pad(u, (0, 0, max(0, n - u.shape[1]), 0))[
        :, -n:]


def mamba2_forward(cfg: ModelConfig, p: dict, x: Tensor,
                   force_ref: bool = False):
    """Full-sequence SSD. x [B,S,d] -> (y [B,S,d], MambaCache)."""
    B, S, _ = x.shape
    d_in, nh, hd, ds = dims(cfg)
    z, xi_raw, Bc, Cc, dt = _split_proj(cfg, p, x)
    bc_raw = torch.cat([Bc, Cc], dim=-1)
    xi = _conv_full(p["conv_x"], p["conv_b_x"], xi_raw)
    bc = _conv_full(p["conv_bc"], p["conv_b_bc"], bc_raw)
    dt = torch.nn.functional.softplus(dt.float() + p["dt_bias"])  # [B,S,nh]
    la = dt * -torch.exp(p["A_log"])                               # log decay
    xh = xi.reshape(B, S, nh, hd)
    sharded = None
    if force_ref and is_dtensor(xh):  # sharded: per rank's heads
        sharded = on_local_heads(
            lambda *a: kops.ssd_scan(*a, force_ref=True),
            (xh, dt, la, bc[..., :ds], bc[..., ds:]), (0, 0, 0, 0, 0),
            (2, 2, 2, None, None), ((0, 2), (0, 1)))
    y, s_final = sharded if sharded is not None else kops.ssd_scan(
        xh, dt, la, bc[..., :ds], bc[..., ds:], force_ref=force_ref)
    y = y.float() + p["D"][None, None, :, None] * xh.float()
    y = _gated_norm(cfg, p, y.reshape(B, S, d_in).to(x.dtype), z)
    out = torch.matmul(y, p["out_proj"])
    K = cfg.ssm.d_conv
    cache = MambaCache(conv_x=_tail(xi_raw, K - 1),
                       conv_bc=_tail(bc_raw, K - 1), ssd=s_final, length=S)
    return out, cache


def init_mamba_cache(cfg: ModelConfig, batch: int, device,
                     lead: tuple = ()) -> MambaCache:
    """Zeroed recurrent state at length 0, leaves stacked on ``lead``."""
    d_in, nh, hd, ds = dims(cfg)
    K = cfg.ssm.d_conv
    return MambaCache(
        conv_x=torch.zeros(lead + (batch, K - 1, d_in), dtype=cfg.tdtype,
                           device=device),
        conv_bc=torch.zeros(lead + (batch, K - 1, 2 * ds), dtype=cfg.tdtype,
                            device=device),
        ssd=torch.zeros(lead + (batch, nh, hd, ds), dtype=torch.float32,
                        device=device),
        length=0)


def mamba2_decode(cfg: ModelConfig, p: dict, x: Tensor, cache: MambaCache):
    """Single-token recurrence. x [B,1,d] -> (y [B,1,d], next MambaCache)."""
    B = x.shape[0]
    d_in, nh, hd, ds = dims(cfg)
    z, xi, Bc, Cc, dt = _split_proj(cfg, p, x)
    bc = torch.cat([Bc, Cc], dim=-1)
    win_x = torch.cat([cache.conv_x, xi], dim=1)         # [B,K,d_in]
    win_bc = torch.cat([cache.conv_bc, bc], dim=1)       # [B,K,2ds]
    cx = torch.einsum("bkc,kc->bc", win_x, p["conv_x"]) + p["conv_b_x"]
    cbc = torch.einsum("bkc,kc->bc", win_bc, p["conv_bc"]) + p["conv_b_bc"]
    xi = torch.nn.functional.silu(cx.float()).to(x.dtype)
    bc_act = torch.nn.functional.silu(cbc.float()).to(x.dtype)
    Bc, Cc = bc_act[:, :ds], bc_act[:, ds:]
    dt = torch.nn.functional.softplus(dt[:, 0].float() + p["dt_bias"])
    a = torch.exp(dt * -torch.exp(p["A_log"]))          # [B,nh]
    xh = xi.reshape(B, nh, hd).float()
    s_new = a[:, :, None, None] * cache.ssd + torch.einsum(
        "bh,bs,bhp->bhps", dt, Bc.float(), xh)
    y = torch.einsum("bs,bhps->bhp", Cc.float(), s_new)
    y = y + p["D"][None, :, None] * xh
    y = _gated_norm(cfg, p, y.reshape(B, 1, d_in).to(x.dtype), z)
    out = torch.matmul(y, p["out_proj"])
    return out, MambaCache(conv_x=win_x[:, 1:], conv_bc=win_bc[:, 1:],
                           ssd=s_new, length=cache.length + 1)
