"""The scans' shape-only plans and the arithmetic of their tensor-core
kernels, on the CPU (``kernels/scan_plan.py``, ``csrc/ssd_scan.cu``,
``csrc/rwkv6_scan.cu``).

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
Here:

* the plans: each head's channel slices partition hd exactly, every slice
  width is one of the kernels' templates, the grid covers the SMs in one
  wave at the serve shapes, shared memory fits a CTA, and the plan is a
  function of shapes only;
* RWKV6's boundary factoring, emulated in torch in f64 and in f32 at
  decays down to -3000 a token with some channels at 0: every factor is
  <= 1, the factored scores are finite and equal the per-pair form (in
  f32 to 1e-6 of their scale: the two differ only in rounding, and both
  sit about 1e-4 from f64 through the f32 cumsum), where the TPU kernel's
  factoring overflows;
* the kernels' bf16 rounding points, emulated in torch (bf16 operands,
  f32 sums, the state's operand split hi/lo) against the plain versions
  at the serve shapes: within the bf16 scan tolerance (rtol 5e-2, atol
  5e-2 * max|y|) and the state's 1e-3; one rounding of the state's
  operand instead breaks the state's tolerance, which is why the kernels
  split it. This predicts on the CPU what the card shows.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import rwkv6_scan as rk
from repro_torch.kernels import scan_plan as sp
from repro_torch.kernels import ssd_scan as sk
from repro_torch.compat import cap_xdist_threads

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

SMS = 132
SMEM_MAX = 227 * 1024
BF16, F32 = torch.bfloat16, torch.float32
STATE_TOL = 1e-3
SERVE_S = (1, 17, 64, 65, 113, 128, 200)


def _plans(kind, B, H, S, hd, dtype):
    if kind == "rwkv6":
        return rk.rwkv6_plan(B, H, S, hd, dtype, SMS)
    return sk.ssd_plan(B, H, S, hd, hd, dtype, SMS)


# ------------------------------------------------------------------ plans
@pytest.mark.parametrize("kind", ["rwkv6", "ssd"])
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("heads", [3, 32, 112])
@pytest.mark.parametrize("hd", [16, 20, 32, 64])
def test_slices_partition_the_channels(kind, dtype, heads, hd):
    """Every channel of a head falls in exactly one slice, no slice is
    empty, and the width is one of the tensor-core kernels' templates no
    wider than hd rounded up to 16."""
    plan = _plans(kind, 1, heads, 113, hd, dtype)
    chans = [c for s in range(plan.n_slices) for c in plan.channels(s)]
    assert chans == list(range(hd))
    assert all(len(plan.channels(s)) for s in range(plan.n_slices))
    assert plan.slice_width in sp.SLICE_CHOICES
    assert plan.slice_width <= 16 * math.ceil(hd / 16)
    assert plan.ctas == heads * plan.n_slices


@pytest.mark.parametrize("S", SERVE_S)
@pytest.mark.parametrize("kind,H,slices", [("rwkv6", 32, 4), ("ssd", 112, 2)])
def test_plan_fits_the_card_at_serve_shapes(kind, H, slices, S):
    """rwkv6-1.6b's 32 heads of 64 take four slices of 16 (128 CTAs),
    zamba2-7b's 112 heads two slices of 32 (224 CTAs): each grid fills the
    card in one wave, at every prompt length; the chunk count follows S."""
    for dtype in (BF16, F32):
        plan = _plans(kind, 1, H, S, 64, dtype)
        assert plan.n_slices == slices and plan.ctas == H * slices
        assert plan.ctas >= 0.95 * SMS
        assert plan.ctas <= SMS * plan.ctas_per_sm
        assert plan.n_chunks == math.ceil(S / sp.CHUNK)
        assert plan.smem_bytes <= SMEM_MAX
        assert plan.route == ("tensor_core" if dtype == BF16 else "scalar")


@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("ds", [16, 32, 64])
@pytest.mark.parametrize("S", [1, 65, 200])
def test_plan_widths_and_state_sizes(hd, ds, S):
    """The plans at every width and state size: shared memory within a
    CTA's, the widest slice that still gives every SM a CTA (else the
    narrowest), one plan whatever S is but for its chunk count."""
    for B, H in ((1, 3), (2, 32), (1, 112), (4, 64)):
        for dtype in (BF16, F32):
            for plan in (sk.ssd_plan(B, H, S, hd, ds, dtype, SMS),
                         rk.rwkv6_plan(B, H, S, hd, dtype, SMS)):
                assert plan.smem_bytes <= SMEM_MAX
                wider = [p for p in sp.SLICE_CHOICES
                         if plan.slice_width < p <= 16 * math.ceil(hd / 16)]
                assert all(B * H * math.ceil(hd / p) < SMS for p in wider)
                narrower = [p for p in sp.SLICE_CHOICES
                            if p < plan.slice_width]
                assert not narrower or plan.ctas >= SMS
    a = sk.ssd_plan(1, 112, 1, hd, ds, BF16, SMS)
    b = sk.ssd_plan(1, 112, 200, hd, ds, BF16, SMS)
    assert (a.slice_width, a.ctas, a.smem_bytes) == \
        (b.slice_width, b.ctas, b.smem_bytes)


def test_plans_are_functions_of_shapes_only():
    """Equal shapes give equal (hashable, frozen) plans; RWKV6's carries
    the diagonal blocks' height, SSD's none; bf16 runs on tensor cores."""
    p1 = rk.rwkv6_plan(1, 32, 113, 64, BF16, SMS)
    assert p1 == rk.rwkv6_plan(1, 32, 113, 64, BF16, SMS)
    assert hash(p1) == hash(rk.rwkv6_plan(1, 32, 113, 64, BF16, SMS))
    assert p1.diag_rows == rk.DIAG_ROWS in (8, 16)
    assert sk.ssd_plan(1, 112, 113, 64, 64, BF16, SMS).diag_rows == 0
    assert p1.fields()["diag_rows"] == rk.DIAG_ROWS
    assert "diag_rows" not in sk.ssd_plan(1, 112, 113, 64, 64, F32,
                                          SMS).fields()


@pytest.mark.parametrize("heads,hd,width", [
    (1, 64, 16), (32, 64, 16), (112, 64, 32), (132, 64, 64), (264, 64, 64),
    (66, 64, 32), (33, 64, 16), (200, 16, 16), (112, 48, 32), (1, 8, 16)])
def test_slice_rule(heads, hd, width):
    assert sp.slice_width(heads, hd, SMS) == width


# ------------------------------------------------ RWKV6 boundary factoring
def _extreme_rwkv(seed, B=2, Q=64, hd=64, dtype=torch.float64):
    """r, k ~ 0.5 N; decays -exp(3 N - 1) capped at -3000 a token, every
    seventh channel at 0 and a -3000 token now and then (the model clips
    its decay at -2981)."""
    rng = np.random.default_rng(seed)
    r = 0.5 * rng.standard_normal((B, Q, hd))
    k = 0.5 * rng.standard_normal((B, Q, hd))
    la = -np.minimum(np.exp(3.0 * rng.standard_normal((B, Q, hd)) - 1.0),
                     3000.0)
    la[..., ::7] = 0.0
    la[:, 5::11, 1::5] = -3000.0
    return [torch.from_numpy(a).to(dtype) for a in (r, k, la)]


def _cums(la):
    """Inclusive and exclusive cumulative log decays along the tokens."""
    c = torch.cumsum(la, -2)
    return c, torch.cat([torch.zeros_like(c[..., :1, :]), c[..., :-1, :]],
                        -2)


def _per_pair(r, k, c, e):
    """sum_t r_it k_jt exp(e_it - c_jt) for j < i (0 elsewhere): the
    exponent is formed only there, where it is <= 0."""
    Q = r.shape[-2]
    strict = torch.ones(Q, Q, dtype=torch.bool).tril(-1)[..., None]
    w = torch.exp(torch.where(strict, e[..., :, None, :] - c[..., None, :, :],
                              torch.tensor(-torch.inf, dtype=r.dtype)))
    return torch.einsum("...it,...jt,...ijt->...ij", r, k, w)


def _factored(r, k, c, e, diag=8, rnd=lambda t: t):
    """The tensor-core kernel's strict intra scores of a 64-token chunk:
    16-row key blocks J < I as one product of r o exp(e - c_b) and
    k o exp(c_b - c) with b the last row of J; with diag = 8 the same
    inside each diagonal sub-block at its row 7; the diagonal blocks of
    diag rows per pair. ``rnd`` rounds the factored operands (the
    kernel's bf16). Returns (scores, the largest factor)."""
    Q = r.shape[-2]
    A = torch.zeros(r.shape[:-1] + (Q,), dtype=r.dtype)
    fmax = 0.0

    def block(rows, cols, b):
        nonlocal fmax
        fr = torch.exp(e[..., rows, :] - c[..., b:b + 1, :])
        fk = torch.exp(c[..., b:b + 1, :] - c[..., cols, :])
        fmax = max(fmax, float(fr.max()), float(fk.max()))
        return rnd(r[..., rows, :] * fr) @ rnd(k[..., cols, :] * fk) \
            .transpose(-1, -2)
    for i0 in range(0, Q, 16):
        for j0 in range(0, i0, 16):
            A[..., i0:i0 + 16, j0:j0 + 16] = block(
                slice(i0, i0 + 16), slice(j0, j0 + 16), j0 + 15)
        if diag == 8:
            A[..., i0 + 8:i0 + 16, i0:i0 + 8] = block(
                slice(i0 + 8, i0 + 16), slice(i0, i0 + 8), i0 + 7)
        for h in range(i0, i0 + 16, diag):
            s = slice(h, h + diag)
            A[..., s, s] = _per_pair(r[..., s, :], k[..., s, :], c[..., s, :],
                                     e[..., s, :])
    return A, fmax


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("diag", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rwkv6_boundary_factoring_matches_per_pair(dtype, diag, seed):
    """At decays down to -3000 a token, with channels at 0: every factor
    is <= 1, the factored scores are finite and equal the per-pair form
    (f64 to 1e-12, f32 to 1e-6 of their scale; the f32 cumsum itself sits
    about 1e-4 from f64 in both forms)."""
    r, k, la = _extreme_rwkv(seed, dtype=dtype)
    c, e = _cums(la)
    want = _per_pair(r, k, c, e)
    got, fmax = _factored(r, k, c, e, diag)
    assert fmax <= 1.0
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())
    scale = float(want.abs().max())
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    assert float((got - want).abs().max()) <= tol * scale


def test_tpu_factoring_overflows_where_the_boundary_factoring_does_not():
    """The TPU kernel's exp(cs_i - la_i) * exp(-cs_j) overflows f32 at
    these decays; the kernel's factors stay in [0, 1]."""
    r, k, la = _extreme_rwkv(0, dtype=torch.float32)
    c, e = _cums(la)
    assert not bool(torch.isfinite(torch.exp(-c)).all())
    got, fmax = _factored(r, k, c, e)
    assert fmax <= 1.0 and bool(torch.isfinite(got).all())


# ------------------------------------------------- bf16 rounding points
def _bf(t):
    return t.to(torch.bfloat16).float()


def _hilo(t):
    hi = _bf(t)
    return hi + _bf(t - hi)


def _ssd_emulation(x, dt, a, Bm, Cm, split=True):
    """csrc/ssd_scan.cu's bf16 route: C, B, x exact; the scores and the
    state's bf16 copy (inter term) rounded once; the state's operand
    w o B split hi/lo (``split=False``: rounded once); f32 sums."""
    B, H, S, hd = x.shape
    Q = sp.CHUNK
    xf, bq_all, cq_all = x.float(), Bm.float(), Cm.float()
    s = torch.zeros(B, H, hd, Bm.shape[-1])
    ys = []
    for c0 in range(0, S, Q):
        sl = slice(c0, min(c0 + Q, S))
        xq, dq, bq, cq = xf[:, :, sl], dt[:, :, sl], bq_all[:, :, sl], \
            cq_all[:, :, sl]
        n = xq.shape[2]
        cum = torch.cumsum(a[:, :, sl], 2)
        causal = torch.ones(n, n, dtype=torch.bool).tril()
        dec = torch.exp(torch.where(causal, cum[..., :, None]
                                    - cum[..., None, :], -torch.inf))
        sc = _bf(cq @ bq.transpose(-1, -2) * dec * dq[..., None, :])
        ys.append(torch.exp(cum)[..., None]
                  * (cq @ _bf(s).transpose(-1, -2)) + sc @ xq)
        w = dq * torch.exp(cum[..., -1:] - cum)
        wb = w[..., None] * bq
        s = torch.exp(cum[..., -1])[..., None, None] * s \
            + xq.transpose(-1, -2) @ (_hilo(wb) if split else _bf(wb))
    return torch.cat(ys, 2).to(x.dtype), s


def _rwkv_emulation(r, k, v, la, u, split=True, diag=8):
    """csrc/rwkv6_scan.cu's bf16 route: r, k, v exact; the factored score
    operands, the scores, r o exp(e) and the state's bf16 copy rounded
    once; the diagonal blocks per pair in f32; the state's operand
    k o exp(c_last - c) split hi/lo (``split=False``: rounded once)."""
    B, H, S, hd = r.shape
    Q = sp.CHUNK
    rf, kf, vf = r.float(), k.float(), v.float()
    s = torch.zeros(B, H, hd, hd)
    ys = []
    for c0 in range(0, S, Q):
        n = min(Q, S - c0)
        pad = (0, 0, 0, Q - n)             # rows past S: zeros, la = 0
        rq, kq, vq, lq = (torch.nn.functional.pad(t[:, :, c0:c0 + n], pad)
                          for t in (rf, kf, vf, la))
        c, e = _cums(lq)
        A, _ = _factored(rq, kq, c, e, diag, _bf)
        A = A + torch.diag_embed((rq * u[:, :, None] * kq).sum(-1))
        y = _bf(rq * torch.exp(e)) @ _bf(s) + _bf(A) @ vq
        cl = c[:, :, -1]
        kst = kq * torch.exp(cl[:, :, None] - c)
        s = torch.exp(cl)[..., None] * s \
            + (_hilo(kst) if split else _bf(kst)).transpose(-1, -2) @ vq
        ys.append(y[:, :, :n])
    return torch.cat(ys, 2).to(r.dtype), s


def _serve_inputs(kind, S, seed):
    """chip_smoke.py's draws at the serve shapes, in the models' layouts."""
    g = torch.Generator().manual_seed(seed)
    if kind == "rwkv6":
        r, k, v = ((0.5 * torch.randn(1, S, 32, 64, generator=g)).to(BF16)
                   .transpose(1, 2) for _ in range(3))
        la = -torch.exp(1.5 * torch.randn(1, S, 32, 64, generator=g) - 2.0) \
            .transpose(1, 2)
        u = (0.3 * torch.randn(32, 64, generator=g))[None].expand(1, 32, 64)
        return r, k, v, la, u
    x = torch.randn(1, S, 112, 64, generator=g).to(BF16).transpose(1, 2)
    dt = torch.nn.functional.softplus(
        torch.randn(1, S, 112, generator=g) - 2.0).transpose(1, 2)
    bc = torch.randn(1, S, 128, generator=g).to(BF16)
    return (x, dt, -dt, bc[..., :64][:, None].expand(1, 112, S, 64),
            bc[..., 64:][:, None].expand(1, 112, S, 64))


def _errors(kind, S, split, seed=0):
    args = _serve_inputs(kind, S, seed)
    if kind == "rwkv6":
        got, want = _rwkv_emulation(*args, split=split), \
            rk.rwkv6_scan_plain(*args)
    else:
        got, want = _ssd_emulation(*args, split=split), \
            sk.ssd_scan_plain(*args)
    (gy, gs), (wy, ws) = got, want
    y_excess = ((gy.float() - wy.float()).abs()
                / (5e-2 * float(wy.float().abs().max())
                   + 5e-2 * wy.float().abs())).max()
    s_excess = ((gs - ws).abs() / (STATE_TOL + STATE_TOL * ws.abs())).max()
    return float(y_excess), float(s_excess)


@pytest.mark.parametrize("S", [18, 113, 128])
@pytest.mark.parametrize("kind", ["rwkv6", "ssd"])
def test_bf16_rounding_points_hold_the_tolerances(kind, S):
    """The kernels' rounding points at the serve shapes: y within the bf16
    scan tolerance and the state within 1e-3 of the plain versions (the
    emulated state sits about 100 times inside its tolerance)."""
    y_excess, s_excess = _errors(kind, S, split=True)
    assert y_excess <= 1.0 and s_excess <= 0.1


@pytest.mark.parametrize("kind", ["rwkv6", "ssd"])
def test_one_rounding_of_the_state_operand_breaks_the_state_tolerance(kind):
    """Why the kernels split the state's operand hi/lo: rounded once, its
    2^-9 per term, summed into the f32 state, puts it outside 1e-3."""
    _, s_excess = _errors(kind, 113, split=False)
    assert s_excess > 1.0
