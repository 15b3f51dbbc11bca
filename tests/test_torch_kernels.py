"""Kernel parity: the port's plain versions and oracles against the JAX
package's Pallas kernels (interpret mode) and oracles. The Hopper kernels
themselves are held to their plain versions on the card, in
``tests/test_torch_cuda.py``.

Tolerances are those of ``tests/test_kernels.py``: rtol = atol = 2e-5 in
f32 and 2e-2 in bf16. Inputs are drawn with numpy and handed to both
packages. Shapes with a fully masked row are avoided against the oracles:
the kernels mask with -1e30 and the oracles with -inf, so such rows differ
by design.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.decode_attention import paged_decode_attention as j_paged
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.fused_ffn import fused_ffn as j_ffn
from repro_torch.kernels import LAUNCHES, ops, ref, reset_launches
from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_plain, paged_decode_attention,
    paged_decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.fused_ffn import fused_ffn, fused_ffn_plain
from repro_torch.compat import cap_xdist_threads

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(rng, shape, dtype, scale=1.0):
    """The same numpy draw as a JAX array and a torch tensor of ``dtype``."""
    jd, td, _ = DTYPES[dtype]
    x = (scale * rng.standard_normal(shape)).astype(np.float32)
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, dtype=np.float32),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------ flash attention
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("Bkv,G,S,hd,bq,bk", [
    (2, 2, 64, 64, 32, 32),
    (1, 4, 32, 32, 16, 32),
])
def test_flash_plain_matches_pallas(dtype, Bkv, G, S, hd, bq, bk):
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng, (Bkv, G, S, hd), dtype)
    jk, tk = _pair(rng, (Bkv, S, hd), dtype)
    jv, tv = _pair(rng, (Bkv, S, hd), dtype)
    tol = DTYPES[dtype][2]
    want = j_flash(jq, jk, jv, causal=True, block_q=bq, block_k=bk,
                   interpret=True)
    # the TPU layout [Bkv, G, S, hd] is the port's B = Bkv, H = 1
    got = flash_attention(tq[:, None], tk[:, None], tv[:, None])[:, 0]
    _close(got, want, tol)
    qf, kf, vf = (jq.reshape(Bkv * G, S, hd),
                  jnp.repeat(jk[:, None], G, 1).reshape(Bkv * G, S, hd),
                  jnp.repeat(jv[:, None], G, 1).reshape(Bkv * G, S, hd))
    oracle = jref.flash_attention_ref(qf, kf, vf).reshape(want.shape)
    _close(got, oracle, tol)
    t_oracle = ref.flash_attention_ref(
        tq.reshape(Bkv * G, S, hd),
        tk[:, None].expand(Bkv, G, S, hd).reshape(Bkv * G, S, hd),
        tv[:, None].expand(Bkv, G, S, hd).reshape(Bkv * G, S, hd))
    _close(t_oracle.reshape(got.shape), oracle, tol)


@pytest.mark.parametrize("S,window", [(37, None), (50, 16)])
def test_flash_plain_ragged_and_window_match_oracle(S, window):
    """Every S (the Pallas kernel needs S % block == 0) and windows."""
    rng = np.random.default_rng(1)
    B, H, G, hd = 1, 2, 2, 32
    jq, tq = _pair(rng, (B * H * G, S, hd), "float32")
    jk, tk = _pair(rng, (B * H, S, hd), "float32")
    jv, tv = _pair(rng, (B * H, S, hd), "float32")
    got = flash_attention_plain(tq.reshape(B, H, G, S, hd),
                                tk.reshape(B, H, S, hd),
                                tv.reshape(B, H, S, hd), window=window)
    kf = jnp.repeat(jk[:, None], G, 1).reshape(B * H * G, S, hd)
    vf = jnp.repeat(jv[:, None], G, 1).reshape(B * H * G, S, hd)
    want = jref.flash_attention_ref(jq, kf, vf, window=window)
    _close(got.reshape(B * H * G, S, hd), want, 2e-5)


@pytest.mark.parametrize("force_ref", [False, True])
def test_ops_flash_matches_jax_ops(force_ref):
    rng = np.random.default_rng(2)
    B, S, nh, nkv, hd = 2, 32, 4, 2, 32
    jq, tq = _pair(rng, (B, S, nh, hd), "float32")
    jk, tk = _pair(rng, (B, S, nkv, hd), "float32")
    jv, tv = _pair(rng, (B, S, nkv, hd), "float32")
    want = jops.flash_attention(jq, jk, jv, force_ref=True)
    got = ops.flash_attention(tq, tk, tv, force_ref=force_ref)
    _close(got, want, 2e-5)


# ------------------------------------------------------------ decode attention
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("Bkv,G,C,hd,bc", [(2, 2, 256, 64, 128),
                                           (3, 4, 128, 32, 64)])
def test_decode_plain_matches_pallas(dtype, Bkv, G, C, hd, bc):
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng, (Bkv, G, hd), dtype)
    jk, tk = _pair(rng, (Bkv, C, hd), dtype)
    jv, tv = _pair(rng, (Bkv, C, hd), dtype)
    lengths = rng.integers(1, C + 1, size=Bkv)        # ragged, never empty
    valid = np.arange(C)[None, :] < lengths[:, None]
    tol = DTYPES[dtype][2]
    want = j_decode(jq, jk, jv, jnp.asarray(valid), block_c=bc,
                    interpret=True)
    got = decode_attention(tq[:, None], tk[:, None], tv[:, None],
                           torch.from_numpy(valid))[:, 0]
    _close(got, want, tol)
    oracle = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(valid))
    _close(got, oracle, tol)
    _close(ref.decode_attention_ref(tq, tk, tv, torch.from_numpy(valid)),
           oracle, tol)


def test_decode_plain_ring_mask_matches_oracle():
    """An arbitrary (ring-window) mask, not only a prefix."""
    rng = np.random.default_rng(4)
    B, H, G, C, hd = 2, 2, 2, 64, 32
    jq, tq = _pair(rng, (B * H, G, hd), "float32")
    jk, tk = _pair(rng, (B * H, C, hd), "float32")
    jv, tv = _pair(rng, (B * H, C, hd), "float32")
    valid = np.zeros((B, C), bool)
    valid[0, 10:40] = True
    valid[1, :5] = True
    valid[1, 50:] = True
    got = decode_attention_plain(tq.reshape(B, H, G, hd),
                                 tk.reshape(B, H, C, hd),
                                 tv.reshape(B, H, C, hd),
                                 torch.from_numpy(valid))
    want = jref.decode_attention_ref(jq, jk, jv,
                                     jnp.asarray(np.repeat(valid, H, 0)))
    _close(got.reshape(B * H, G, hd), want, 2e-5)


@pytest.mark.parametrize("force_ref", [False, True])
def test_ops_decode_matches_jax_ops(force_ref):
    rng = np.random.default_rng(5)
    B, C, nh, nkv, hd = 2, 64, 4, 2, 32
    jq, tq = _pair(rng, (B, 1, nh, hd), "float32")
    jk, tk = _pair(rng, (B, C, nkv, hd), "float32")
    jv, tv = _pair(rng, (B, C, nkv, hd), "float32")
    valid = np.arange(C)[None, :] <= np.array([[20], [63]])
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(valid),
                                 force_ref=True)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(valid),
                               force_ref=force_ref)
    _close(got, want, 2e-5)


# ------------------------------------------------------ paged decode attention
def _paged_case(rng, B, nkv, P, bs, n_bt, pos):
    """Block tables drawn from a shuffled pool: slot b owns the blocks
    covering positions 0..pos[b], the rest of its row is the sentinel P."""
    perm = rng.permutation(P)
    tables = np.full((B, n_bt), P, np.int32)
    used = 0
    for b in range(B):
        n = min(pos[b] // bs + 1, n_bt)
        tables[b, :n] = perm[used:used + n]
        used += n
    assert used <= P
    return tables, np.asarray(pos, np.int32)


PAGED_SHAPES = [  # B, nkv, G, hd, P, bs, n_bt, pos (ragged; one past the table)
    (4, 2, 2, 64, 40, 8, 8, [0, 7, 30, 63]),
    (3, 1, 4, 32, 16, 16, 4, [17, 45, 100]),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,nkv,G,hd,P,bs,n_bt,pos", PAGED_SHAPES)
def test_paged_plain_matches_pallas(dtype, B, nkv, G, hd, P, bs, n_bt, pos):
    """Sentinel entries, a shuffled pool and ragged positions; every slot
    sees at least one position (an all-sentinel row averages V over a
    clipped block in the TPU kernel and gets 0 from the Hopper kernel)."""
    rng = np.random.default_rng(8)
    jq, tq = _pair(rng, (B, nkv, G, hd), dtype)
    jk, tk = _pair(rng, (P, bs, nkv, hd), dtype)
    jv, tv = _pair(rng, (P, bs, nkv, hd), dtype)
    tables, pos = _paged_case(rng, B, nkv, P, bs, n_bt, pos)
    tol = DTYPES[dtype][2]
    want = j_paged(jq, jk, jv, jnp.asarray(tables), jnp.asarray(pos),
                   interpret=True)
    got = paged_decode_attention(tq, tk, tv, torch.from_numpy(tables),
                                 torch.from_numpy(pos))
    _close(got, want, tol)
    _close(paged_decode_attention_plain(tq, tk, tv, torch.from_numpy(tables),
                                        torch.from_numpy(pos)), want, tol)


def test_paged_plain_all_sentinel_row_matches_pallas():
    """A retired row (all sentinel): the plain version keeps the TPU
    kernel's average over the clipped block."""
    rng = np.random.default_rng(9)
    jq, tq = _pair(rng, (2, 2, 2, 32), "float32")
    jk, tk = _pair(rng, (6, 4, 2, 32), "float32")
    jv, tv = _pair(rng, (6, 4, 2, 32), "float32")
    tables = np.array([[3, 0, 6], [6, 6, 6]], np.int32)
    pos = np.array([9, 5], np.int32)
    want = j_paged(jq, jk, jv, jnp.asarray(tables), jnp.asarray(pos),
                   interpret=True)
    got = paged_decode_attention_plain(tq, tk, tv, torch.from_numpy(tables),
                                       torch.from_numpy(pos))
    _close(got, want, 2e-5)


@pytest.mark.parametrize("force_ref", [False, True])
def test_ops_paged_matches_jax_ops(force_ref):
    rng = np.random.default_rng(10)
    B, nh, nkv, hd, P, bs, n_bt = 3, 4, 2, 32, 24, 8, 6
    jq, tq = _pair(rng, (B, 1, nh, hd), "float32")
    jk, tk = _pair(rng, (P, bs, nkv, hd), "float32")
    jv, tv = _pair(rng, (P, bs, nkv, hd), "float32")
    tables, pos = _paged_case(rng, B, nkv, P, bs, n_bt, [5, 33, 47])
    want = jops.paged_decode_attention(jq, jk, jv, jnp.asarray(tables),
                                       jnp.asarray(pos), force_ref=True)
    got = ops.paged_decode_attention(tq, tk, tv, torch.from_numpy(tables),
                                     torch.from_numpy(pos),
                                     force_ref=force_ref)
    _close(got, want, 2e-5)


def test_paged_launch_refuses_non_cuda_tensors():
    from repro_torch.kernels import decode_attention as da
    q = torch.zeros(1, 2, 2, 8)
    pool = torch.zeros(3, 4, 2, 8)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        da._launch_paged(q, pool, pool, torch.zeros(1, 2, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32))


# ----------------------------------------------------------------- fused ffn
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("E,T,d,f,bt,bf", [(1, 32, 64, 128, 16, 64),
                                           (2, 16, 32, 64, 16, 32)])
def test_ffn_plain_matches_pallas(dtype, E, T, d, f, bt, bf):
    rng = np.random.default_rng(6)
    jx, tx = _pair(rng, (E, T, d), dtype)
    jg, tg = _pair(rng, (E, d, f), dtype, scale=d ** -0.5)
    ju, tu = _pair(rng, (E, d, f), dtype, scale=d ** -0.5)
    jd_, td_ = _pair(rng, (E, f, d), dtype, scale=f ** -0.5)
    tol = DTYPES[dtype][2]
    want = j_ffn(jx, jg, ju, jd_, block_t=bt, block_f=bf, interpret=True)
    got = fused_ffn(tx, tg, tu, td_)
    _close(got, want, tol)
    oracle = jref.fused_ffn_ref(jx, jg, ju, jd_)
    _close(got, oracle, tol)
    _close(ref.fused_ffn_ref(tx, tg, tu, td_), oracle, tol)
    _close(ops.fused_ffn(tx, tg, tu, td_, force_ref=True), oracle, tol)


def test_ffn_plain_any_row_count():
    """T = 1 and a ragged T: shapes the Pallas kernel's blocks refuse."""
    rng = np.random.default_rng(7)
    for T in (1, 37):
        jx, tx = _pair(rng, (1, T, 32), "float32")
        jg, tg = _pair(rng, (1, 32, 96), "float32", scale=0.2)
        ju, tu = _pair(rng, (1, 32, 96), "float32", scale=0.2)
        jd_, td_ = _pair(rng, (1, 96, 32), "float32", scale=0.1)
        _close(fused_ffn_plain(tx, tg, tu, td_),
               jref.fused_ffn_ref(jx, jg, ju, jd_), 2e-5)


def test_cpu_tensors_launch_nothing():
    """On the CPU the wrappers take the plain versions and count nothing."""
    reset_launches()
    x = torch.zeros(1, 2, 8)
    fused_ffn(x, torch.zeros(1, 8, 32), torch.zeros(1, 8, 32),
              torch.zeros(1, 32, 8))
    paged_decode_attention(torch.zeros(1, 2, 2, 8), torch.zeros(3, 4, 2, 8),
                           torch.zeros(3, 4, 2, 8),
                           torch.zeros(1, 2, dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int32))
    assert sum(LAUNCHES.values()) == 0


def test_kernel_launch_refuses_non_cuda_tensors():
    """The launch path checks its operands and raises; it never falls back
    to the plain version (which the wrappers take only for CPU tensors)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ffn as ff
    q = torch.zeros(1, 1, 2, 4, 8)
    kv = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        fa._launch(q, kv, kv, True, None)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        da._launch(q[:, :, :, 0], kv, kv, torch.ones(1, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        ff._launch(torch.zeros(1, 2, 8), torch.zeros(1, 8, 4),
                   torch.zeros(1, 8, 4), torch.zeros(1, 4, 8))
