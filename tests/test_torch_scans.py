"""Scan parity: the port's plain ``rwkv6_scan`` and ``ssd_scan`` (the
chunked form its CUDA kernels compute) against the JAX package's Pallas
kernels in interpret mode and its sequential oracles, and the ``ops``
adapters from the models' layouts. The Hopper kernels themselves are held
to these plain versions on the card, in ``tests/test_torch_cuda.py``.

Tolerances are ``tests/test_kernels.py``'s: the RWKV scan at rtol = atol
= 1e-4 (f32); the SSD scan at rtol 1e-3, atol 2e-5 * max|y| (f32) and
rtol = 5e-2, atol = 5e-2 * max|y| (bf16), its state at 1e-3. The bf16
RWKV case takes the SSD scan's bf16 tolerance: test_kernels has none of
its own. Ragged S (37, 113), which the Pallas kernels refuse (they need
the chunk to divide S), is held to the oracles only. Inputs are drawn
with numpy and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as j_rwkv
from repro.kernels.ssd_scan import ssd_scan as j_ssd
from repro_torch.kernels import LAUNCHES, _build, ops, ref, reset_launches
from repro_torch.kernels import rwkv6_scan as rk
from repro_torch.kernels import ssd_scan as sk

JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x: np.ndarray, dtype: str = "float32"):
    """The same numpy array as a JAX array and a torch tensor of ``dtype``."""
    x = x.astype(np.float32)
    return jnp.asarray(x).astype(JD[dtype]), torch.from_numpy(x).to(TD[dtype])


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, dtype=np.float32)


def _rwkv_inputs(rng, BH, S, hd, dtype="float32", decay_shift=-2.0):
    """test_kernels' draw: r,k,v ~ 0.5 N, la = -exp(0.3 N + shift), u 0.3 N.
    Each torch tensor is [BH, 1, S, hd] (the kernel layout with H = 1)."""
    r, k, v = (_pair(0.5 * rng.standard_normal((BH, S, hd)), dtype)
               for _ in range(3))
    la = _pair(-np.exp(0.3 * rng.standard_normal((BH, S, hd))
                       + decay_shift))
    u = _pair(0.3 * rng.standard_normal((BH, hd)))
    j = [t[0] for t in (r, k, v, la, u)]
    t = [x[1][:, None] for x in (r, k, v, la, u)]
    return j, t


def _ssd_inputs(rng, BH, S, hd, ds, dtype="float32"):
    """test_kernels' draw: dt = softplus(N), a = -softplus(N) / 2."""
    x = _pair(rng.standard_normal((BH, S, hd)), dtype)
    dt = _pair(np.log1p(np.exp(rng.standard_normal((BH, S)))))
    a = _pair(-np.log1p(np.exp(rng.standard_normal((BH, S)))) * 0.5)
    Bm = _pair(rng.standard_normal((BH, S, ds)), dtype)
    Cm = _pair(rng.standard_normal((BH, S, ds)), dtype)
    j = [t[0] for t in (x, dt, a, Bm, Cm)]
    t = [v[1][:, None] for v in (x, dt, a, Bm, Cm)]
    return j, t


def _scaled_tol(want: np.ndarray, dtype: str) -> dict:
    scale = float(np.abs(want).max()) + 1e-6
    if dtype == "float32":
        return dict(rtol=1e-3, atol=2e-5 * scale)
    return dict(rtol=5e-2, atol=5e-2 * scale)


# ------------------------------------------------------------------ RWKV6
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,S,hd,chunk", [(2, 128, 64, 32), (3, 64, 32, 64)])
def test_rwkv6_plain_matches_pallas(dtype, BH, S, hd, chunk):
    j, t = _rwkv_inputs(np.random.default_rng(0), BH, S, hd, dtype)
    wy, ws = j_rwkv(*j, chunk=chunk, interpret=True)
    y, s = rk.rwkv6_scan_plain(*t)
    assert y.dtype == TD[dtype] and s.dtype == torch.float32
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == "float32"
           else _scaled_tol(_np(wy), dtype))
    np.testing.assert_allclose(_np(y[:, 0]), _np(wy), **tol)
    np.testing.assert_allclose(_np(s[:, 0]), _np(ws), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S", [37, 113])
@pytest.mark.parametrize("decay_shift", [-2.0, 1.6])
def test_rwkv6_plain_ragged_matches_oracle(S, decay_shift):
    """Prime lengths, at test_kernels' decays (mean la = -0.14) and at
    strong ones (mean la = -5 per token, a chunk's cumulative decay far
    below -88, where the TPU kernel's factored exp(-cs_j) overflows f32)."""
    j, t = _rwkv_inputs(np.random.default_rng(1), 2, S, 64,
                        decay_shift=decay_shift)
    wy, ws = jref.rwkv_scan_ref(*j)
    y, s = rk.rwkv6_scan_plain(*t)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    np.testing.assert_allclose(_np(y[:, 0]), _np(wy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(s[:, 0]), _np(ws), rtol=1e-4, atol=1e-4)


def test_rwkv6_chunk_length_does_not_change_the_result():
    _, t = _rwkv_inputs(np.random.default_rng(2), 2, 113, 32)
    y32, s32 = rk.rwkv6_scan_plain(*t)
    for chunk in (1, 7, 64, 128):
        y, s = rk.rwkv6_scan_plain(*t, chunk=chunk)
        torch.testing.assert_close(y, y32, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(s, s32, rtol=1e-4, atol=1e-4)


def test_rwkv6_oracle_matches_jax_oracle_with_s0():
    rng = np.random.default_rng(3)
    j, t = _rwkv_inputs(rng, 2, 19, 32)
    js0, ts0 = _pair(0.2 * rng.standard_normal((2, 32, 32)))
    wy, ws = jref.rwkv_scan_ref(*j, s0=js0)
    y, s = ref.rwkv_scan_ref(*(x[:, 0] for x in t), s0=ts0)
    np.testing.assert_allclose(_np(y), _np(wy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(s), _np(ws), rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------------- SSD
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,S,hd,ds,chunk", [(2, 128, 64, 64, 64),
                                             (4, 64, 32, 16, 32)])
def test_ssd_plain_matches_pallas(dtype, BH, S, hd, ds, chunk):
    j, t = _ssd_inputs(np.random.default_rng(4), BH, S, hd, ds, dtype)
    wy, ws = j_ssd(*j, chunk=chunk, interpret=True)
    y, s = sk.ssd_scan_plain(*t)
    assert y.dtype == TD[dtype] and s.dtype == torch.float32
    np.testing.assert_allclose(_np(y[:, 0]), _np(wy),
                               **_scaled_tol(_np(wy), dtype))
    np.testing.assert_allclose(_np(s[:, 0]), _np(ws), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [37, 113])
def test_ssd_plain_ragged_matches_oracle(dtype, S):
    j, t = _ssd_inputs(np.random.default_rng(5), 3, S, 64, 64, dtype)
    wy, ws = jref.ssd_scan_ref(*j)
    y, s = sk.ssd_scan_plain(*t)
    np.testing.assert_allclose(_np(y[:, 0]), _np(wy),
                               **_scaled_tol(_np(wy), dtype))
    np.testing.assert_allclose(_np(s[:, 0]), _np(ws), rtol=1e-3, atol=1e-3)


def test_ssd_oracle_matches_jax_oracle_with_s0():
    rng = np.random.default_rng(6)
    j, t = _ssd_inputs(rng, 2, 21, 16, 8)
    js0, ts0 = _pair(0.2 * rng.standard_normal((2, 16, 8)))
    wy, ws = jref.ssd_scan_ref(*j, s0=js0)
    y, s = ref.ssd_scan_ref(*(x[:, 0] for x in t), s0=ts0)
    np.testing.assert_allclose(_np(y), _np(wy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(s), _np(ws), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ ops model layouts
def _model_rwkv(rng, B=2, S=37, nh=3, hd=32):
    r, k, v = (0.5 * rng.standard_normal((B, S, nh, hd)) for _ in range(3))
    la = -np.exp(0.3 * rng.standard_normal((B, S, nh, hd)) - 2.0)
    u = 0.3 * rng.standard_normal((nh, hd))
    return [torch.from_numpy(x.astype(np.float32)) for x in (r, k, v, la, u)]


def _model_ssd(rng, B=2, S=37, nh=3, hd=32, ds=16):
    x = rng.standard_normal((B, S, nh, hd))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh))))
    la = -np.log1p(np.exp(rng.standard_normal((B, S, nh)))) * 0.5
    bc = rng.standard_normal((B, S, 2 * ds))
    x, dt, la, bc = (torch.from_numpy(a.astype(np.float32))
                     for a in (x, dt, la, bc))
    return x, dt, la, bc[..., :ds], bc[..., ds:]


def test_ops_rwkv6_matches_jax_oracle_per_head():
    """Model layout [B,S,nh,hd] through the adapter against the JAX oracle
    on the flattened [B*nh, S, hd] layout, kernel path and force_ref."""
    r, k, v, la, u = _model_rwkv(np.random.default_rng(7))
    B, S, nh, hd = r.shape

    def flat(t):
        return jnp.asarray(t.permute(0, 2, 1, 3).reshape(B * nh, S, hd)
                           .numpy())
    wy, ws = jref.rwkv_scan_ref(flat(r), flat(k), flat(v), flat(la),
                                jnp.asarray(np.tile(u.numpy(), (B, 1))))
    wy = _np(wy).reshape(B, nh, S, hd).transpose(0, 2, 1, 3)
    for force_ref in (False, True):
        y, s = ops.rwkv6_scan(r, k, v, la, u, force_ref=force_ref)
        assert tuple(y.shape) == (B, S, nh, hd)
        np.testing.assert_allclose(_np(y), wy, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(s).reshape(B * nh, hd, hd), _np(ws),
                                   rtol=1e-4, atol=1e-4)


def test_ops_ssd_matches_jax_oracle_per_head():
    """Model layout with B/C [B,S,ds] shared by the heads of a row, against
    the JAX oracle on B/C repeated per head."""
    x, dt, la, Bm, Cm = _model_ssd(np.random.default_rng(8))
    B, S, nh, hd = x.shape
    ds = Bm.shape[-1]

    def rows(t):
        return jnp.asarray(np.repeat(t.numpy()[:, None], nh, axis=1)
                           .reshape(B * nh, S, ds))
    wy, ws = jref.ssd_scan_ref(
        jnp.asarray(x.permute(0, 2, 1, 3).reshape(B * nh, S, hd).numpy()),
        jnp.asarray(dt.permute(0, 2, 1).reshape(B * nh, S).numpy()),
        jnp.asarray(la.permute(0, 2, 1).reshape(B * nh, S).numpy()),
        rows(Bm), rows(Cm))
    wy = _np(wy).reshape(B, nh, S, hd).transpose(0, 2, 1, 3)
    for force_ref in (False, True):
        y, s = ops.ssd_scan(x, dt, la, Bm, Cm, force_ref=force_ref)
        assert tuple(y.shape) == (B, S, nh, hd)
        np.testing.assert_allclose(_np(y), wy, **_scaled_tol(wy, "float32"))
        np.testing.assert_allclose(_np(s).reshape(B * nh, hd, ds), _np(ws),
                                   rtol=1e-3, atol=1e-3)


def test_ops_pass_views_not_copies(monkeypatch):
    """The adapters hand the kernels strided views of the model's tensors:
    u on a batch stride of 0, B/C on a head stride of 0, nothing copied."""
    seen = {}

    def capture(name):
        def fn(*args):
            seen[name] = args
            return args[0], None
        return fn
    monkeypatch.setattr(ops, "_rwkv", capture("rwkv"))
    monkeypatch.setattr(ops, "_ssd", capture("ssd"))
    r, k, v, la, u = _model_rwkv(np.random.default_rng(9))
    ops.rwkv6_scan(r, k, v, la, u)
    for src, got in zip((r, k, v, la, u), seen["rwkv"]):
        assert got.data_ptr() == src.data_ptr()
    assert seen["rwkv"][0].shape == (2, 3, 37, 32)
    assert seen["rwkv"][4].shape == (2, 3, 32)
    assert seen["rwkv"][4].stride(0) == 0
    x, dt, la, Bm, Cm = _model_ssd(np.random.default_rng(10))
    ops.ssd_scan(x, dt, la, Bm, Cm)
    for src, got in zip((x, dt, la, Bm, Cm), seen["ssd"]):
        assert got.data_ptr() == src.data_ptr()
    assert seen["ssd"][3].shape == (2, 3, 37, 16)
    assert seen["ssd"][3].stride(1) == 0 and seen["ssd"][4].stride(1) == 0


# ------------------------------------------------------ wrappers and build
def test_cpu_scans_launch_nothing():
    reset_launches()
    _, t = _rwkv_inputs(np.random.default_rng(11), 1, 5, 8)
    rk.rwkv6_scan(*t)
    _, t = _ssd_inputs(np.random.default_rng(12), 1, 5, 8, 4)
    sk.ssd_scan(*t)
    assert LAUNCHES["rwkv6_scan"] == 0 and LAUNCHES["ssd_scan"] == 0


def test_scan_launch_refuses_non_cuda_tensors():
    """The launch paths check their operands and raise; they never fall
    back to the plain version."""
    _, t = _rwkv_inputs(np.random.default_rng(13), 1, 5, 8)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        rk._launch(*t[:4], t[4].expand(1, 1, 8))
    _, t = _ssd_inputs(np.random.default_rng(14), 1, 5, 8, 4)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        sk._launch(*t)


@pytest.mark.parametrize("name,replaces", [
    ("rwkv6_scan", "src/repro/kernels/rwkv6_scan.py : rwkv6_scan"),
    ("ssd_scan", "src/repro/kernels/ssd_scan.py : ssd_scan"),
])
def test_scan_sources_are_built_and_documented(name, replaces):
    src = _build.CSRC / f"{name}.cu"
    assert name in _build.SOURCES and src.exists()
    text = src.read_text()
    assert f"Replaces: {replaces}" in text
    assert f'extern "C" int {name}_fwd' in text
