"""The Hopper kernels against their plain versions, on the card.

Runs where a CUDA device is (``python -m pytest -q -m cuda
tests/test_torch_cuda.py``) and skips elsewhere; it imports no JAX, so it
runs on a machine without it. Shapes are the serving paths' at
qwen3-0.6b's, rwkv6-1.6b's and zamba2-7b's widths, including ragged prompt
lengths, T = 1 and ragged paged positions. Tolerances: the repo's kernel
tolerances (2e-5 f32, 2e-2 bf16), except 1e-4 for the f32 FFN, whose
1024- and 3072-term sums run in another order than ``torch.matmul``'s,
and tests/test_kernels.py's scan tolerances for the two scans (outputs
at 1e-4 for rwkv6 and rtol 1e-3, atol 2e-5 * max|y| for SSD in f32,
rtol 5e-2, atol 5e-2 * max|y| in bf16; states at 1e-3). A paged slot with no visible
position (all sentinel) is kept out of the comparison: the kernel gives
it 0 where the plain version, like the TPU kernel, averages a clipped
block; the engine discards such rows. The split-KV decode cases hold
bf16 to chip_smoke.py's 2 ulps of each row's largest |out| (at most
2e-2) and cover head widths 30-256, 1-12 query heads per kv head, the
stacked cache's and the pool's per-layer views, an unaligned view, masks
that stress the merge, determinism and the absence of host syncs. The
prefill flash and FFN cases cover both routes of each (tensor cores in
bf16, scalar FMAs in f32 and at widths off the 16-byte grid), head widths
64-256, 1-8 query heads per kv head, S from 1 to 1024, T from 1 to 904,
a d_ff that is no multiple of any tile, E = 2, bit-equal repeated calls,
no host sync, and one CUDA-graph capture replayed. The scan cases cover
both routes at decays down to -3000 a token (RWKV6) and -50 (SSD), widths
16-64 (and 20, off the 16-byte grid), S from 1 to 200, B = 2 with the
model's strides, each slice width forced, and the same determinism, sync
and graph checks. The decode step as a CUDA graph: on both engines and
every family in bf16, the replayed chunk equals the same step run
eagerly bit for bit (tokens and cache), replays make no host sync, one
capture serves every budget, ``LAUNCHES`` counts the replayed kernels,
and seeded stochastic decoding is reproducible through the graph.
"""
import dataclasses

import pytest
import torch

from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_plain, paged_decode_attention,
    paged_decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.fused_ffn import fused_ffn, fused_ffn_plain
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_plain
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: the Hopper kernels run only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [16, 37, 128])
def test_flash_matches_plain(cuda_device, dtype, S):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    B, H, G, hd = 1, 8, 2, 128
    q = torch.randn(B, S, H, G, hd, generator=g, device=cuda_device) \
        .to(dtype).permute(0, 2, 3, 1, 4)
    k = torch.randn(B, S, H, hd, generator=g, device=cuda_device) \
        .to(dtype).permute(0, 2, 1, 3)
    v = torch.randn(B, S, H, hd, generator=g, device=cuda_device) \
        .to(dtype).permute(0, 2, 1, 3)
    reset_launches()
    got = flash_attention(q, k, v)
    assert LAUNCHES["flash_attention"] == 1
    want = flash_attention_plain(q, k, v)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_window_matches_plain(cuda_device, dtype):
    """The sliding-window mask of the TPU kernel (not on the qwen3 path),
    on the scalar route (f32) and on tensor cores (bf16)."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn(2, 2, 2, 100, 64, generator=g, device=cuda_device)
    k = torch.randn(2, 2, 100, 64, generator=g, device=cuda_device)
    v = torch.randn(2, 2, 100, 64, generator=g, device=cuda_device)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        flash_attention(q, k, v, window=24).float(),
        flash_attention_plain(q, k, v, window=24).float(), rtol=tol,
        atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_window_4096_past_the_window_matches_plain(cuda_device,
                                                         dtype):
    """starcoder2-3b's prefill past its window: 2 kv heads of 128, 12 query
    heads each, S = 4200 with a window of 4096, so the last 104 queries'
    first key tiles are skipped and their tile at the window's edge is
    masked in part; the model's views."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    B, S, H, G, hd = 1, 4200, 2, 12, 128
    q = torch.randn(B, S, H, G, hd, generator=g, device=cuda_device) \
        .to(dtype).permute(0, 2, 3, 1, 4)
    k = torch.randn(B, S, H, hd, generator=g, device=cuda_device) \
        .to(dtype).permute(0, 2, 1, 3)
    v = torch.randn(B, S, H, hd, generator=g, device=cuda_device) \
        .to(dtype).permute(0, 2, 1, 3)
    reset_launches()
    got = flash_attention(q, k, v, window=4096)
    assert LAUNCHES["flash_attention"] == 1
    want = flash_attention_plain(q, k, v, window=4096)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_matches_plain(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    B, C, H, G, hd = 2, 2048, 8, 2, 128
    q = torch.randn(B, H, G, hd, generator=g, device=cuda_device).to(dtype)
    cache = torch.randn(2, B, C, H, hd, generator=g,
                        device=cuda_device).to(dtype)
    k, v = cache[0].permute(0, 2, 1, 3), cache[1].permute(0, 2, 1, 3)
    valid = torch.arange(C, device=cuda_device)[None] \
        <= torch.tensor([[300], [1500]], device=cuda_device)
    got = decode_attention(q, k, v, valid)
    want = decode_attention_plain(q, k, v, valid)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 37, 128])
def test_ffn_matches_plain(cuda_device, dtype, T):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    d, f = 1024, 3072
    x = torch.randn(1, T, d, generator=g, device=cuda_device).to(dtype)
    wg = (torch.randn(1, d, f, generator=g, device=cuda_device)
          * d ** -0.5).to(dtype)
    wu = (torch.randn(1, d, f, generator=g, device=cuda_device)
          * d ** -0.5).to(dtype)
    wd = (torch.randn(1, f, d, generator=g, device=cuda_device)
          * f ** -0.5).to(dtype)
    got = fused_ffn(x, wg, wu, wd)
    want = fused_ffn_plain(x, wg, wu, wd)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_matches_plain(cuda_device, dtype):
    """8 slots of a 2048-token table over a shuffled 1024-block pool, the
    layer view of the engine's stacked pool; slot 7 retired (all
    sentinel) and checked only for a finite output."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    P, bs, n_bt, H, G, hd = 1024, 16, 128, 8, 2, 128
    pos_list = [17, 45, 100, 300, 600, 1100, 1500, 0]
    B = len(pos_list)
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(4))
    tables = torch.full((B, n_bt), P, dtype=torch.int32)
    used = 0
    for b, p in enumerate(pos_list[:-1]):
        n = p // bs + 1
        tables[b, :n] = perm[used:used + n]
        used += n
    tables = tables.to(cuda_device)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=cuda_device)
    q = torch.randn(B, H, G, hd, generator=g, device=cuda_device).to(dtype)
    pool = torch.randn(2, 3, P + 1, bs, H, hd, generator=g,
                       device=cuda_device).to(dtype)
    kp, vp = pool[0, 1, :P], pool[1, 1, :P]
    reset_launches()
    got = paged_decode_attention(q, kp, vp, tables, pos)
    assert LAUNCHES["paged_decode_attention"] == 1
    want = paged_decode_attention_plain(q, kp, vp, tables, pos)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got[:-1].float(), want[:-1].float(),
                               rtol=tol, atol=tol)
    assert bool(torch.isfinite(got[-1].float()).all())


@pytest.mark.cuda
def test_short_paged_drain_exact_budgets(cuda_device):
    """Reduced qwen3 in bf16 through the paged engine with a pool too small
    for all requests at once: exact budgets, the kernel launched, the
    block accounting restored."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, reduced
    from repro_torch.serving import ContinuousBatchingEngine

    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b")),
                              dtype="bfloat16")
    eng = ContinuousBatchingEngine(cfg, init_params(cfg, 0, cuda_device),
                                   max_slots=4, capacity=128, chunk=8,
                                   paged=True, block_size=16, n_blocks=8)
    reqs = [(i, torch.arange(3 + 5 * i).numpy() % 97 + 1, 9 + 7 * i, 2)
            for i in range(6)]
    reset_launches()
    pending, done = list(reqs), {}
    while pending or eng.n_active:
        if pending:
            flags = eng.admit_many(pending)
            pending = [r for r, ok in zip(pending, flags) if not ok]
        for s in eng.step_chunk():
            done[s.rid] = s.tokens
    assert {rid: len(t) for rid, t in done.items()} \
        == {rid: b + x for rid, _, b, x in reqs}
    assert LAUNCHES["paged_decode_attention"] > 0
    assert eng.check_block_invariants()
    assert eng.allocator.n_free == 8 and eng.allocator.reserved == 0


def _scan_tol(want: torch.Tensor, dtype) -> dict:
    scale = float(want.float().abs().max()) + 1e-6
    if dtype == torch.float32:
        return dict(rtol=1e-3, atol=2e-5 * scale)
    return dict(rtol=5e-2, atol=5e-2 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [18, 113, 128])
def test_rwkv6_scan_matches_plain(cuda_device, dtype, S):
    """rwkv6-1.6b's prefill shape: 32 heads of 64, the model's layout
    [B, S, H, hd] viewed as [B, H, S, hd], u on a batch stride of 0, and
    decays down to about -5 per token."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    B, H, hd = 1, 32, 64

    def model_view(scale=0.5):
        return (torch.randn(B, S, H, hd, generator=g, device=cuda_device)
                * scale).to(dtype).permute(0, 2, 1, 3)
    r, k, v = model_view(), model_view(), model_view()
    la = -torch.exp(torch.randn(B, S, H, hd, generator=g, device=cuda_device)
                    * 1.5 - 2.0).permute(0, 2, 1, 3)
    u = (0.3 * torch.randn(H, hd, generator=g, device=cuda_device))[None] \
        .expand(B, H, hd)
    reset_launches()
    y, sf = rwkv6_scan(r, k, v, la, u)
    assert LAUNCHES["rwkv6_scan"] == 1
    wy, wsf = rwkv6_scan_plain(r, k, v, la, u)
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
           else _scan_tol(wy, dtype))
    torch.testing.assert_close(y.float(), wy.float(), **tol)
    torch.testing.assert_close(sf, wsf, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [18, 113, 128])
def test_ssd_scan_matches_plain(cuda_device, dtype, S):
    """zamba2-7b's prefill shape: 112 heads of 64, state 64, B/C one
    [B, S, ds] row shared by the heads (head stride 0)."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    B, H, hd, ds = 1, 112, 64, 64
    x = torch.randn(B, S, H, hd, generator=g, device=cuda_device) \
        .to(dtype).permute(0, 2, 1, 3)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=g, device=cuda_device)
        - 2.0).permute(0, 2, 1)
    a = -dt
    bc = torch.randn(B, S, 2 * ds, generator=g, device=cuda_device) \
        .to(dtype)
    Bm = bc[..., :ds][:, None].expand(B, H, S, ds)
    Cm = bc[..., ds:][:, None].expand(B, H, S, ds)
    reset_launches()
    y, sf = ssd_scan(x, dt, a, Bm, Cm)
    assert LAUNCHES["ssd_scan"] == 1
    wy, wsf = ssd_scan_plain(x, dt, a, Bm, Cm)
    torch.testing.assert_close(y.float(), wy.float(), **_scan_tol(wy, dtype))
    torch.testing.assert_close(sf, wsf, rtol=1e-3, atol=1e-3)


# ---- the scans on tensor cores: extreme decays, widths, slices, B = 2
def _rwkv_case(dev, dtype, B, S, H, hd, seed=31, extreme=False):
    """r, k, v, la as [B, H, S, hd] views of the model's [B, S, H, hd]
    projections and u [H, hd] on a batch stride of 0. ``extreme``: decays
    from about -5e-5 down to -3000 per token (the model clips its decay
    at -2981), every seventh channel at 0 and a -3000 token now and then."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = ((0.5 * torch.randn(B, S, H, hd, generator=g, device=dev))
               .to(dtype).permute(0, 2, 1, 3) for _ in range(3))
    z = torch.randn(B, S, H, hd, generator=g, device=dev)
    la = -torch.exp(3.0 * z - 1.0).clamp(max=3000.0) if extreme \
        else -torch.exp(1.5 * z - 2.0)
    if extreme:
        la[..., ::7] = 0.0
        la[:, 5::11, :, 1::5] = -3000.0
    u = (0.3 * torch.randn(H, hd, generator=g, device=dev))[None] \
        .expand(B, H, hd)
    return r, k, v, la.permute(0, 2, 1, 3), u


def _ssd_case(dev, dtype, B, S, H, hd, ds, seed=32, extreme=False):
    """x [B, H, S, hd] and dt, a [B, H, S] views of the model's layouts, B/C
    one [B, S, ds] row shared by the heads (head stride 0). ``extreme``:
    dt * A from 0 down to -50 per token, every fifth head at 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, S, H, hd, generator=g, device=dev).to(dtype) \
        .permute(0, 2, 1, 3)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=g, device=dev) - 2.0)
    a = -dt
    if extreme:
        a = -(dt * torch.exp(3.0 * torch.randn(B, S, H, generator=g,
                                               device=dev))).clamp(max=50.0)
        a[..., ::5] = 0.0
    bc = torch.randn(B, S, 2 * ds, generator=g, device=dev).to(dtype)
    Bm = bc[..., :ds][:, None].expand(B, H, S, ds)
    Cm = bc[..., ds:][:, None].expand(B, H, S, ds)
    return x, dt.permute(0, 2, 1), a.permute(0, 2, 1), Bm, Cm


def _check_scan(got, want, dtype, rwkv):
    y, sf = got
    wy, wsf = want
    assert bool(torch.isfinite(y.float()).all())
    tol = (dict(rtol=1e-4, atol=1e-4) if rwkv and dtype == torch.float32
           else _scan_tol(wy, dtype))
    torch.testing.assert_close(y.float(), wy.float(), **tol)
    torch.testing.assert_close(sf, wsf, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 17, 64, 65, 200])
def test_scans_extreme_decays_match_plain(cuda_device, dtype, S):
    """The serve shapes' heads at decays the TPU kernel's factored form
    overflows on: RWKV6 down to -3000 a token, SSD dt * A down to -50,
    some channels (heads) without decay; y finite and within the scan
    tolerances, the state within 1e-3."""
    reset_launches()
    args = _rwkv_case(cuda_device, dtype, 1, S, 32, 64, extreme=True)
    _check_scan(rwkv6_scan(*args), rwkv6_scan_plain(*args), dtype, True)
    args = _ssd_case(cuda_device, dtype, 1, S, 112, 64, 64, extreme=True)
    _check_scan(ssd_scan(*args), ssd_scan_plain(*args), dtype, False)
    assert LAUNCHES["rwkv6_scan"] == 1 and LAUNCHES["ssd_scan"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 20])
@pytest.mark.parametrize("S", [1, 17, 65, 200])
def test_scans_widths_match_plain(cuda_device, dtype, hd, S):
    """Every width 16 / 32 / 64 (and 20, off the 16-byte grid: element
    copies) at B = 2 with the model's strides, SSD at ds = hd; few heads,
    so the plan takes its narrowest slices."""
    args = _rwkv_case(cuda_device, dtype, 2, S, 3, hd)
    _check_scan(rwkv6_scan(*args), rwkv6_scan_plain(*args), dtype, True)
    args = _ssd_case(cuda_device, dtype, 2, S, 3, hd, hd)
    _check_scan(ssd_scan(*args), ssd_scan_plain(*args), dtype, False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [16, 32, 64])
def test_scans_every_slice_width_matches_plain(cuda_device, monkeypatch,
                                               dtype, width):
    """Each of the kernels' slice widths, forced on the serve shapes at
    S = 113, and SSD at ds = 16 against hd = 64."""
    from repro_torch.kernels import rwkv6_scan as rk
    from repro_torch.kernels import ssd_scan as sk
    for mod in (rk, sk):
        monkeypatch.setattr(mod, "slice_width", lambda *a: width)
    args = _rwkv_case(cuda_device, dtype, 1, 113, 32, 64)
    _check_scan(rwkv6_scan(*args), rwkv6_scan_plain(*args), dtype, True)
    for ds in (64, 16):
        args = _ssd_case(cuda_device, dtype, 1, 113, 112, 64, ds)
        _check_scan(ssd_scan(*args), ssd_scan_plain(*args), dtype, False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scans_batch4_match_plain(cuda_device, dtype):
    """Both scans at B = 4, S = 64, at rwkv6-1.6b's and zamba2-7b's widths:
    a continuous admission group of four equal-length prompts (the plan
    cuts 4 x 32 wkv heads into two slices each, 4 x 112 SSD heads into
    one)."""
    args = _rwkv_case(cuda_device, dtype, 4, 64, 32, 64)
    _check_scan(rwkv6_scan(*args), rwkv6_scan_plain(*args), dtype, True)
    args = _ssd_case(cuda_device, dtype, 4, 64, 112, 64, 64)
    _check_scan(ssd_scan(*args), ssd_scan_plain(*args), dtype, False)


@pytest.mark.cuda
def test_zamba2_shared_block_shapes_match_plain(cuda_device):
    """The shared block's kernels at zamba2-7b's widths: flash and slot
    decode at head_dim 112 (G = 1), the FFN at d 3584 / d_ff 14336 at
    T = 1 and at a prefill T = 37 (a 4-row tile: 16 rows need more shared
    memory than a CTA has)."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    H, hd, S, C = 32, 112, 37, 256
    q = torch.randn(1, S, H, 1, hd, generator=g, device=cuda_device) \
        .permute(0, 2, 3, 1, 4)
    kv = torch.randn(2, 1, S, H, hd, generator=g, device=cuda_device)
    k, v = kv[0].permute(0, 2, 1, 3), kv[1].permute(0, 2, 1, 3)
    torch.testing.assert_close(flash_attention(q, k, v),
                               flash_attention_plain(q, k, v),
                               rtol=2e-5, atol=2e-5)
    qd = torch.randn(1, H, 1, hd, generator=g, device=cuda_device)
    cache = torch.randn(2, 1, C, H, hd, generator=g, device=cuda_device)
    kc, vc = cache[0].permute(0, 2, 1, 3), cache[1].permute(0, 2, 1, 3)
    valid = torch.arange(C, device=cuda_device)[None] < 113
    torch.testing.assert_close(decode_attention(qd, kc, vc, valid),
                               decode_attention_plain(qd, kc, vc, valid),
                               rtol=2e-5, atol=2e-5)
    d, f = 3584, 14336
    for T in (1, 37):
        x = torch.randn(1, T, d, generator=g, device=cuda_device) \
            .to(torch.bfloat16)
        wg, wu = ((torch.randn(1, d, f, generator=g, device=cuda_device)
                   * d ** -0.5).to(torch.bfloat16) for _ in range(2))
        wd = (torch.randn(1, f, d, generator=g, device=cuda_device)
              * f ** -0.5).to(torch.bfloat16)
        torch.testing.assert_close(fused_ffn(x, wg, wu, wd).float(),
                                   fused_ffn_plain(x, wg, wu, wd).float(),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_recurrent_model_decode_kernels_match_reference(cuda_device, arch):
    """Reduced rwkv6 and the hybrid (5 layers, the shared block every 2),
    f32: prefill of a prime-length prompt plus 4 decode steps, kernels
    against force_ref, logits within 1e-3 and the same greedy tokens; the
    scan kernel and, for the hybrid, the attention and FFN kernels ran."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_params, reduced

    cfg = reduced(get_config(arch))
    if arch == "zamba2-7b":
        cfg = dataclasses.replace(reduced(get_config(arch), n_layers=5),
                                  attn_every=2)
    params = init_params(cfg, 0, cuda_device)
    prompt = (torch.arange(37, device=cuda_device) % 97 + 1)[None]
    reset_launches()
    ker = forward(cfg, params, prompt, return_cache=True, cache_capacity=64)
    ref = forward(cfg, params, prompt, return_cache=True, cache_capacity=64,
                  force_ref=True)
    torch.testing.assert_close(ker.logits, ref.logits, rtol=0, atol=1e-3)
    tok = ref.logits[:, -1:].argmax(-1)
    ck, cr = ker.cache, ref.cache
    for _ in range(4):
        k = decode_step(cfg, params, tok, ck)
        r = decode_step(cfg, params, tok, cr, force_ref=True)
        torch.testing.assert_close(k.logits, r.logits, rtol=0, atol=1e-3)
        assert torch.equal(k.logits.argmax(-1), r.logits.argmax(-1))
        tok, ck, cr = r.logits.argmax(-1), k.cache, r.cache
    scan = "rwkv6_scan" if arch == "rwkv6-1.6b" else "ssd_scan"
    assert LAUNCHES[scan] == cfg.n_layers
    if arch == "zamba2-7b":
        for name in ("flash_attention", "decode_attention", "fused_ffn"):
            assert LAUNCHES[name] > 0, name


# ---- split-KV decode kernels: widths, views, masks that stress the merge
def _decode_tol(want: torch.Tensor) -> torch.Tensor:
    """Per-row absolute tolerance of a decode output [B, ...]: f32 2e-5;
    bf16 2 ulps of the row's largest |out|, at most 2e-2 (chip_smoke.py's
    DECODE_BF16_ULPS: kernel and plain round p and out at the same points
    and differ in f32 summation order and in the running max p is rounded
    against)."""
    if want.dtype == torch.float32:
        return torch.full((want.shape[0],), 2e-5, device=want.device)
    m = want.float().abs().flatten(1).amax(1).clamp_min(2.0 ** -126)
    return (2 * torch.exp2(torch.floor(torch.log2(m)) - 7)).clamp_max(2e-2)


def _assert_decode_close(got, want, rows=None):
    if rows is not None:
        got, want = got[rows], want[rows]
    tol = _decode_tol(want).view((-1,) + (1,) * (want.dim() - 1))
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol).all()), \
        f"max err {float(err.max())}, per-row tol {tol.flatten().tolist()}"


def _slot_case(dev, dtype, B, C, H, G, hd, valid, seed=11, layer=1):
    """q and layer ``layer`` of a stacked [L, B, C, H, hd] cache pair, as
    the model passes it: k/v [B, H, C, hd] strided views."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, G, hd, generator=g, device=dev).to(dtype)
    cache = torch.randn(2, 3, B, C, H, hd, generator=g, device=dev).to(dtype)
    k = cache[0, layer].permute(0, 2, 1, 3)
    v = cache[1, layer].permute(0, 2, 1, 3)
    return q, k, v, valid


def _prefix_valid(dev, C, lengths):
    return torch.arange(C, device=dev)[None] \
        < torch.tensor(lengths, device=dev)[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,G", [(64, 4), (112, 1), (128, 2), (256, 2),
                                  (36, 8), (30, 12)])
def test_split_decode_widths_match_plain(cuda_device, dtype, hd, G):
    """The stacked cache's per-layer view at the serve widths (64, 112,
    128), the widest head (256), a width off the 16-byte vector (36 bf16,
    30 f32) and 1 to 12 query heads per kv head; one launch counted."""
    B, C, H = 3, 2048, 4
    valid = _prefix_valid(cuda_device, C, [1, 700, 2048])
    q, k, v, valid = _slot_case(cuda_device, dtype, B, C, H, G, hd, valid)
    reset_launches()
    got = decode_attention(q, k, v, valid)
    assert LAUNCHES["decode_attention"] == 1
    _assert_decode_close(got, decode_attention_plain(q, k, v, valid))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_unaligned_view_matches_plain(cuda_device, dtype):
    """A cache view that starts one element off a 16-byte boundary takes
    the element-wise copy of the same kernel."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    B, C, H, G, hd = 2, 512, 2, 2, 64
    flat = torch.randn(2 * B * C * H * hd + 1, generator=g,
                       device=cuda_device).to(dtype)
    kv = flat[1:].view(2, B, C, H, hd)
    k, v = kv[0].permute(0, 2, 1, 3), kv[1].permute(0, 2, 1, 3)
    q = torch.randn(B, H, G, hd, generator=g, device=cuda_device).to(dtype)
    valid = _prefix_valid(cuda_device, C, [300, 512])
    _assert_decode_close(decode_attention(q, k, v, valid),
                         decode_attention_plain(q, k, v, valid))


def _adversarial_valid(dev, kind, C, plan):
    """[1, C] masks that stress the merge: every visible position inside
    split 0's tiles; a ring window (positions 1000-1300); a full row
    (the dominant score is planted in the last split by the caller)."""
    valid = torch.zeros(1, C, dtype=torch.bool, device=dev)
    if kind == "one_split":
        for t in plan.tiles(0):
            valid[0, t * plan.tile:(t + 1) * plan.tile] = True
    elif kind == "ring":
        valid[0, 1000:1301] = True
    else:
        valid[0, :2000] = True
    return valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["one_split", "ring", "dominant_last"])
def test_split_decode_adversarial_masks(cuda_device, dtype, kind):
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.decode_attention import split_plan

    B, C, H, G, hd = 1, 2048, 8, 2, 128
    plan = split_plan(B, H, C, hd, dtype,
                      _cuda.sm_count(cuda_device.index or 0))
    assert plan.n_split > 1
    valid = _adversarial_valid(cuda_device, kind, C, plan)
    q, k, v, valid = _slot_case(cuda_device, dtype, B, C, H, G, hd, valid)
    if kind == "dominant_last":
        c = plan.tiles(plan.n_split - 1)[0] * plan.tile + 5
        k[:, :, c] = (q[:, :, 0] * 4).to(dtype)     # head 0's score dominates
    got = decode_attention(q, k, v, valid)
    want = decode_attention_plain(q, k, v, valid)
    _assert_decode_close(got, want)
    if kind == "dominant_last":
        torch.testing.assert_close(got[:, :, 0].float(),
                                   v[:, :, c].float(), rtol=0, atol=0.05)


def _paged_tables(P, bs, n_bt, pos_list, holes=(), seed=13):
    """Slot b owns shuffled blocks covering 0..pos[b]; entries listed in
    ``holes`` ((b, j) pairs) and a slot with pos < 0 are sentinels."""
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(seed))
    tables = torch.full((len(pos_list), n_bt), P, dtype=torch.int32)
    used = 0
    for b, p in enumerate(pos_list):
        if p < 0:
            continue
        n = min(p // bs + 1, n_bt)
        tables[b, :n] = perm[used:used + n]
        used += n
    for b, j in holes:
        tables[b, j] = P
    return tables


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,G,bs", [(64, 4, 16), (112, 1, 16),
                                     (128, 2, 16), (256, 2, 16),
                                     (128, 2, 48), (36, 8, 128)])
def test_split_paged_widths_match_plain(cuda_device, dtype, hd, G, bs):
    """One layer of the engine's stacked pool (a view without the trash
    block) at the serve widths and the widest head; block sizes that do
    not divide a 64-position tile; sentinel holes inside a slot's row (a
    tile straddles them, rows masked one by one); an all-sentinel slot,
    which must read 0 and is kept out of the comparison."""
    g = torch.Generator(device=cuda_device).manual_seed(14)
    H, n_pos = 2, 2048
    n_bt = n_pos // bs
    P = 3 * n_bt
    pos_list = [17, 700, n_pos - 1, -1]
    tables = _paged_tables(P, bs, n_bt, pos_list,
                           holes=[(1, 1), (2, 3), (2, n_bt // 2)])
    tables = tables.to(cuda_device)
    pos = torch.tensor([max(p, 0) for p in pos_list], dtype=torch.int32,
                       device=cuda_device)
    B = len(pos_list)
    q = torch.randn(B, H, G, hd, generator=g, device=cuda_device).to(dtype)
    pool = torch.randn(2, 2, P + 1, bs, H, hd, generator=g,
                       device=cuda_device).to(dtype)
    kp, vp = pool[0, 1, :P], pool[1, 1, :P]
    reset_launches()
    got = paged_decode_attention(q, kp, vp, tables, pos)
    assert LAUNCHES["paged_decode_attention"] == 1
    want = paged_decode_attention_plain(q, kp, vp, tables, pos)
    _assert_decode_close(got, want, rows=slice(0, B - 1))
    assert bool((got[-1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["g12_full_ring", "g12_wrapping_ring",
                                  "hd80_g1"])
def test_split_decode_new_dense_shapes_match_plain(cuda_device, dtype,
                                                   case):
    """starcoder2-3b's decode (2 kv heads of 128, 12 query heads each) over
    its ring of 4096: full after a wrap, and a mask that wraps past slot 0
    (slots 3796-4095 and 0-199 valid); stablelm-3b's (32 kv heads of 80,
    one query head each) at 300 valid positions of 2048, batch 2."""
    if case == "hd80_g1":
        B, C, H, G, hd = 2, 2048, 32, 1, 80
        valid = _prefix_valid(cuda_device, C, [300, 1999])
    else:
        B, C, H, G, hd = 1, 4096, 2, 12, 128
        valid = torch.ones(1, C, dtype=torch.bool, device=cuda_device)
        if case == "g12_wrapping_ring":
            valid[0, 200:C - 300] = False
    q, k, v, valid = _slot_case(cuda_device, dtype, B, C, H, G, hd, valid)
    reset_launches()
    got = decode_attention(q, k, v, valid)
    assert LAUNCHES["decode_attention"] == 1
    _assert_decode_close(got, decode_attention_plain(q, k, v, valid))


@pytest.mark.cuda
def test_split_decode_is_deterministic(cuda_device):
    """The merge runs in split order: two calls agree bit for bit."""
    valid = _prefix_valid(cuda_device, 2048, [2000] * 8)
    q, k, v, valid = _slot_case(cuda_device, torch.bfloat16, 8, 2048, 8, 2,
                                128, valid)
    assert torch.equal(decode_attention(q, k, v, valid),
                       decode_attention(q, k, v, valid))


@pytest.mark.cuda
def test_split_decode_calls_make_no_host_sync(cuda_device):
    """A wrapper call reads no tensor on the host (the split plan is made
    from shapes), so a CUDA graph could capture it."""
    valid = _prefix_valid(cuda_device, 2048, [300])
    q, k, v, valid = _slot_case(cuda_device, torch.bfloat16, 1, 2048, 8, 2,
                                128, valid)
    tables = _paged_tables(256, 16, 128, [300]).to(cuda_device)
    pos = torch.tensor([300], dtype=torch.int32, device=cuda_device)
    pool = torch.randn(2, 257, 16, 8, 128, device=cuda_device) \
        .to(torch.bfloat16)
    kp, vp = pool[0, :256], pool[1, :256]
    decode_attention(q, k, v, valid)                 # build and load first
    paged_decode_attention(q, kp, vp, tables, pos)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        decode_attention(q, k, v, valid)
        paged_decode_attention(q, kp, vp, tables, pos)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# ---- prefill flash and the FFN on both routes: widths, views, graphs
def _flash_inputs(dev, dtype, B, S, H, G, hd, seed=21):
    """q/k/v as the model passes them: [B, H, G, S, hd] and [B, H, S, hd]
    views of [B, S, nh, hd] and [B, S, nkv, hd] projections."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, G, hd, generator=g, device=dev).to(dtype)
    kv = torch.randn(2, B, S, H, hd, generator=g, device=dev).to(dtype)
    return (q.permute(0, 2, 3, 1, 4), kv[0].permute(0, 2, 1, 3),
            kv[1].permute(0, 2, 1, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 112, 128, 256, 80, 72])
def test_flash_widths_match_plain(cuda_device, dtype, hd):
    """Head widths 64-256 (80 padded to 128 inside the CTA; 72, no multiple
    of 16, on the scalar route), 1-8 query heads per kv head, S from 1 to
    1024 (ragged edges of the 16-row warp tile and the 64-key tile); one
    launch a call."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.flash_attention import flash_plan, tc_route_ok

    tol = 2e-5 if dtype == torch.float32 else 2e-2
    sms = _cuda.sm_count(cuda_device.index or 0)
    for G in (1, 2, 4, 8):
        for S in (1, 15, 16, 17, 37, 113, 128, 300, 1024):
            q, k, v = _flash_inputs(cuda_device, dtype, 1, S, 2, G, hd)
            plan = flash_plan(1, 2, G, S, hd, dtype, sms)
            assert (plan.route == "tensor_core") == tc_route_ok(hd, dtype)
            reset_launches()
            got = flash_attention(q, k, v)
            assert LAUNCHES["flash_attention"] == 1
            torch.testing.assert_close(
                got.float(), flash_attention_plain(q, k, v).float(),
                rtol=tol, atol=tol, msg=lambda m: f"G={G} S={S}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_model_views_batch2(cuda_device, dtype):
    """B = 2 through ``ops.flash_attention`` on [B, S, nh, hd] projections
    (qwen3's 16 / 8 heads of 128, and a padded admission group of 8 x 113
    in bf16), against the plain version on the same views."""
    from repro_torch.kernels import ops

    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for B, S in ((2, 37), (8, 113)):
        g = torch.Generator(device=cuda_device).manual_seed(22)
        q = torch.randn(B, S, 16, 128, generator=g, device=cuda_device) \
            .to(dtype)
        kv = torch.randn(2, B, S, 8, 128, generator=g, device=cuda_device) \
            .to(dtype)
        got = ops.flash_attention(q, kv[0], kv[1])
        qk = q.reshape(B, S, 8, 2, 128).permute(0, 2, 3, 1, 4)
        want = flash_attention_plain(qk, kv[0].permute(0, 2, 1, 3),
                                     kv[1].permute(0, 2, 1, 3))
        torch.testing.assert_close(
            got.float(), want.permute(0, 3, 1, 2, 4).reshape(B, S, 16, 128)
            .float(), rtol=tol, atol=tol)


def _ffn_inputs(dev, dtype, E, T, d, f, seed=23):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(E, T, d, generator=g, device=dev).to(dtype)
    wg, wu = ((torch.randn(E, d, f, generator=g, device=dev) * d ** -0.5)
              .to(dtype) for _ in range(2))
    wd = (torch.randn(E, f, d, generator=g, device=dev) * f ** -0.5) \
        .to(dtype)
    return x, wg, wu, wd


# f32 runs the scalar kernel, which no serve path gives T = 904 at
# zamba2's widths (its 4-row tiles would take seconds there): that one
# combination is left out of the grid, bf16 covers the shape
FFN_CASES = [(dt, T, E, d, f)
             for dt in (torch.float32, torch.bfloat16)
             for T in (1, 2, 8, 9, 37, 128, 904)
             for E, d, f in ((1, 1024, 3072), (1, 3584, 14336),
                             (2, 1024, 3000))
             if not (dt == torch.float32 and d == 3584 and T == 904)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,T,E,d,f", FFN_CASES)
def test_ffn_shapes_match_plain(cuda_device, dtype, T, E, d, f):
    """Both regimes (16-row decode tiles up to T = 16, 64-row prefill
    tiles beyond), split reductions, qwen3's and zamba2's widths, a d_ff
    of 3000 (no multiple of the 64-column tile) and E = 2; one launch
    counted a call."""
    x, wg, wu, wd = _ffn_inputs(cuda_device, dtype, E, T, d, f)
    reset_launches()
    got = fused_ffn(x, wg, wu, wd)
    assert LAUNCHES["fused_ffn"] == 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(),
                               fused_ffn_plain(x, wg, wu, wd).float(),
                               rtol=tol, atol=tol)


def _prefill_calls(dev):
    """One flash and one FFN call per regime and each scan at serve shapes
    (bf16, and the scans' f32 route)."""
    fl = [_flash_inputs(dev, torch.bfloat16, 1, 128, 8, 2, 128),
          _flash_inputs(dev, torch.bfloat16, 8, 113, 8, 2, 128),
          _flash_inputs(dev, torch.bfloat16, 1, 113, 32, 1, 112)]
    ff = [_ffn_inputs(dev, torch.bfloat16, 1, T, 1024, 3072)
          for T in (1, 8, 128)]
    rw = [_rwkv_case(dev, dt, 1, 113, 32, 64)
          for dt in (torch.bfloat16, torch.float32)]
    sd = [_ssd_case(dev, dt, 1, 113, 112, 64, 64)
          for dt in (torch.bfloat16, torch.float32)]
    return ([lambda a=a: flash_attention(*a) for a in fl]
            + [lambda a=a: fused_ffn(*a) for a in ff]
            + [lambda a=a: rwkv6_scan(*a) for a in rw]
            + [lambda a=a: ssd_scan(*a) for a in sd])


def _equal(got, want) -> bool:
    """Bit-equal outputs: one tensor, or a scan's (y, state)."""
    if isinstance(got, tuple):
        return all(torch.equal(a, b) for a, b in zip(got, want))
    return torch.equal(got, want)


@pytest.mark.cuda
def test_prefill_kernels_are_deterministic(cuda_device):
    """Split reductions sum in split order and the scans' slices in a fixed
    order: repeated calls are bit-equal."""
    for call in _prefill_calls(cuda_device):
        first = call()
        for _ in range(3):
            assert _equal(call(), first)


@pytest.mark.cuda
def test_prefill_kernels_make_no_host_sync(cuda_device):
    """The plans are made from shapes: a call reads no tensor on the host."""
    calls = _prefill_calls(cuda_device)
    for call in calls:                   # build, load, allocate counters
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_prefill_kernels_replay_in_a_cuda_graph(cuda_device):
    """One capture of every call, replayed twice: equal to the eager call
    (the split counters are back at 0 after each replay)."""
    calls = _prefill_calls(cuda_device)
    eager = [call() for call in calls]
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for call in calls:
            call()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [call() for call in calls]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(outs, eager):
            assert _equal(got, want)


# ---- the decode step as a CUDA graph: both engines, every family
def _bf16_model(dev, arch):
    """Reduced ``arch`` in bf16 on the card (the hybrid at 5 layers with the
    shared block every 2), random weights from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, reduced

    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="bfloat16")
    if arch == "zamba2-7b":
        cfg = dataclasses.replace(cfg, n_layers=5, attn_every=2)
    return cfg, init_params(cfg, 0, dev)


GRAPH_REQUESTS = [(i, (torch.arange(3 + 5 * i) * (i + 1)).numpy() % 89 + 2,
                   b, 3) for i, b in enumerate([5, 0, 17, 9, 2, 12])]


def _drain(eng):
    pending, done = list(GRAPH_REQUESTS), {}
    while pending or eng.n_active:
        if pending:
            flags = eng.admit_many(pending)
            pending = [r for r, ok in zip(pending, flags) if not ok]
        for s in eng.step_chunk():
            done[s.rid] = s.tokens
    return done


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _eager(eng):
    """The same engine with its step run eagerly: a cache whose device
    says CPU captures nothing and runs the step each time."""
    from repro_torch.obs import graph_hooks
    eng._graphs = graph_hooks.GraphCache("eager", "cpu")
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["qwen3-0.6b", "qwen3-0.6b-slot",
                                  "qwen3-0.6b-paged", "rwkv6-1.6b",
                                  "zamba2-7b", "starcoder2-3b",
                                  "rwkv6-1.6b-slot", "zamba2-7b-slot",
                                  "starcoder2-3b-slot"])
def test_graph_chunk_equals_eager_chunk(cuda_device, case):
    """The replayed chunk equals the same static-buffer step run eagerly,
    bit for bit: the tokens and every cache leaf, in bf16. ``-slot`` and
    ``-paged`` are the continuous engine (recurrent, hybrid and windowed
    rows in slot mode, admitted in groups of equal length); the rest
    ``DecodeEngine``."""
    import numpy as np

    from repro_torch.obs import graph_hooks
    from repro_torch.serving import ContinuousBatchingEngine, DecodeEngine

    arch = case.rsplit("-", 1)[0] if case.endswith(("slot", "paged")) \
        else case
    cfg, params = _bf16_model(cuda_device, arch)
    graph_hooks.reset()
    runs = []
    for make in (lambda e: e, _eager):
        if case.endswith(("slot", "paged")):
            paged = case.endswith("paged")
            eng = make(ContinuousBatchingEngine(
                cfg, params, max_slots=3, capacity=64, chunk=4, paged=paged,
                **(dict(block_size=8, n_blocks=12) if paged else {})))
            runs.append((_drain(eng), _leaves(eng.cache)))
        else:
            eng = make(DecodeEngine(cfg, params, cache_capacity=64, chunk=4))
            prompts = np.arange(27, dtype=np.int32).reshape(3, 9) % 89 + 2
            out = eng.generate(prompts, [7, 0, 17], max_extra_tokens=3)
            runs.append((out["tokens"].tolist(),
                         _leaves(eng._static[(3, 4)]["cache"])))
    (got, got_cache), (want, want_cache) = runs
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(got_cache, want_cache))
    label = (f"continuous.{case.rsplit('-', 1)[1]}"
             if case.endswith(("slot", "paged")) else "engine.chunk")
    assert graph_hooks.capture_counts()[label] == 1


@pytest.mark.cuda
def test_graph_replay_makes_no_host_sync(cuda_device):
    """The step's eager run and its replays read nothing on the host."""
    import numpy as np

    from repro_torch.serving import DecodeEngine

    cfg, params = _bf16_model(cuda_device, "qwen3-0.6b")
    eng = DecodeEngine(cfg, params, cache_capacity=64, chunk=4)
    logits, cache = eng.prefill(np.ones((2, 9), np.int32))
    key, _, step = eng._prepare(logits.argmax(-1), cache,
                                np.array([20, 20], np.int32),
                                np.array([17, 17], np.int32), None, 4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()                                 # the step, eagerly
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng._graphs.run(key, step)                 # warm-up, then the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(6):
            eng._graphs.run(key, step)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_one_capture_across_budgets_on_card(cuda_device):
    import numpy as np

    from repro_torch.obs import graph_hooks
    from repro_torch.serving import DecodeEngine

    cfg, params = _bf16_model(cuda_device, "qwen3-0.6b")
    graph_hooks.reset()
    eng = DecodeEngine(cfg, params, cache_capacity=64, chunk=4)
    chunks = 0
    for S, budgets in ((8, [3, 7]), (8, [5, 2]), (12, [8, 8]), (5, [1, 6])):
        out = eng.generate(np.ones((2, S), np.int32), budgets,
                           max_extra_tokens=0)
        assert out["n_reasoning"].tolist() == budgets
        chunks += -(-max(budgets) // 4)
    assert graph_hooks.assert_max_captures("engine.chunk", 1) == 1
    assert graph_hooks.transfer_counts()["engine.chunk"] == chunks


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_launches_count_replayed_kernels(cuda_device, paged):
    """A capture takes back the launches it recorded and each replay adds
    them again: after n replays LAUNCHES is the capture's delta times n,
    which is one decode step's kernels (slot or paged decode and the FFN,
    once a layer)."""
    from repro_torch.serving import ContinuousBatchingEngine

    cfg, params = _bf16_model(cuda_device, "qwen3-0.6b")
    eng = ContinuousBatchingEngine(cfg, params, max_slots=3, capacity=64,
                                   chunk=4, paged=paged, block_size=8)
    assert eng.admit(0, GRAPH_REQUESTS[3][1], 40, 0)
    eng._inputs[0, 0] = eng.slots[0].last_token
    step = eng._chunk_step(4)
    reset_launches()
    eng._graphs.run(4, step)                   # warm-up (eager) + capture
    decode = "paged_decode_attention" if paged else "decode_attention"
    one_step = {decode: cfg.n_layers, "fused_ffn": cfg.n_layers}
    assert dict(LAUNCHES) == one_step          # the eager warm-up only
    assert dict(eng._graphs.launches(4)) == one_step
    reset_launches()
    for _ in range(5):
        eng._graphs.run(4, step)
    assert dict(LAUNCHES) == {k: 5 * v for k, v in one_step.items()}


@pytest.mark.cuda
def test_seeded_stochastic_decode_is_reproducible(cuda_device):
    """The engine's generator is registered with its graph: two engines
    with one seed draw the same tokens, another seed others, and the
    replayed chunk path draws what the eager per-token loop draws."""
    import numpy as np

    from repro_torch.serving import DecodeEngine

    cfg, params = _bf16_model(cuda_device, "qwen3-0.6b")
    prompts = np.arange(18, dtype=np.int32).reshape(2, 9) % 89 + 2
    kw = dict(cache_capacity=64, chunk=4, temperature=0.8)
    runs = [DecodeEngine(cfg, params, **kw).generate(
        prompts, [13, 9], max_extra_tokens=0, seed=s)["tokens"]
        for s in (3, 3, 4)]
    loop = DecodeEngine(cfg, params, **kw).generate(
        prompts, [13, 9], max_extra_tokens=0, seed=3,
        use_scan=False)["tokens"]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    np.testing.assert_array_equal(runs[0], loop)


# ---- the int8 KV cache and the server's hooks on the card
@pytest.mark.cuda
@pytest.mark.parametrize("case", ["decode", "slot", "paged"])
def test_int8_graph_chunk_equals_eager_chunk(cuda_device, case):
    """An int8 cache through the replayed chunk equals the same step run
    eagerly, bit for bit (tokens, codes and scales), in bf16; the decode
    launches are the slot kernel's, one a layer a replayed step, and never
    the paged kernel's (an int8 pool is gathered and dequantised)."""
    import numpy as np

    from repro_torch.obs import graph_hooks
    from repro_torch.serving import ContinuousBatchingEngine, DecodeEngine

    cfg, params = _bf16_model(cuda_device, "qwen3-0.6b")
    cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    runs = []
    for make in (lambda e: e, _eager):
        graph_hooks.reset()
        reset_launches()
        if case == "decode":
            eng = make(DecodeEngine(cfg, params, cache_capacity=64, chunk=4))
            prompts = np.arange(27, dtype=np.int32).reshape(3, 9) % 89 + 2
            out = eng.generate(prompts, [7, 0, 17], max_extra_tokens=3)
            runs.append((out["tokens"].tolist(),
                         _leaves(eng._static[(3, 4)]["cache"])))
            label = "engine.chunk"
        else:
            eng = make(ContinuousBatchingEngine(
                cfg, params, max_slots=3, capacity=64, chunk=4,
                paged=case == "paged", block_size=8, n_blocks=12))
            runs.append((_drain(eng), _leaves(eng.cache)))
            label = f"continuous.{case}"
        if len(runs) == 1:
            launches = dict(LAUNCHES)
            steps = (graph_hooks.capture_counts()[label]
                     + graph_hooks.replay_counts()[label])
    (got, got_cache), (want, want_cache) = runs
    assert got == want
    assert any(t.dtype == torch.int8 for t in got_cache)
    assert all(torch.equal(a, b) for a, b in zip(got_cache, want_cache))
    assert "paged_decode_attention" not in launches
    assert launches["decode_attention"] == cfg.n_layers * steps


@pytest.mark.cuda
def test_int8_paged_drain_equals_slot_drain_on_card(cuda_device):
    """With the same admission groups (every request admitted at once),
    the int8 paged drain and the int8 slot drain attend over the same
    dequantised values through the same kernel: equal tokens in bf16."""
    from repro_torch.serving import ContinuousBatchingEngine

    cfg, params = _bf16_model(cuda_device, "qwen3-0.6b")
    cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    kw = dict(max_slots=len(GRAPH_REQUESTS), capacity=64, chunk=4,
              block_size=8)
    paged = _drain(ContinuousBatchingEngine(cfg, params, paged=True, **kw))
    slot = _drain(ContinuousBatchingEngine(cfg, params, **kw))
    assert paged == slot


@pytest.mark.cuda
def test_hooked_server_one_capture_across_ladder_on_card(cuda_device):
    """``LLMServer`` with the admission ladder, faults, tracer and metrics
    over the paged engine on the card: requests are shed, admitted budgets
    are degraded, and the captured step serves every budget (one capture)."""
    import numpy as np

    from repro_torch import faults
    from repro_torch.core import (Problem, ServerParams, TokenBudgetAllocator,
                                  paper_problem, solve)
    from repro_torch.obs import (MetricsRegistry, Tracer, graph_hooks,
                                 validate_request_trees)
    from repro_torch.queueing_sim import generate_stream
    from repro_torch.serving import (AdmissionConfig, AdmissionController,
                                     ContinuousBatchingEngine, LLMServer,
                                     ServerConfig)

    cfg, params = _bf16_model(cuda_device, "qwen3-0.6b")
    base = paper_problem()
    prob = Problem(tasks=base.tasks, server=ServerParams(0.3, 30.0, 64.0))
    lengths = solve(prob).lengths_int.astype(np.float64)
    tasks = prob.tasks
    es = float((tasks.pi.numpy() * (tasks.t0.numpy()
                                    + tasks.c.numpy() * lengths)).sum())
    alloc = TokenBudgetAllocator(prob, ewma_halflife=2.0,
                                 min_resolve_interval=10 ** 9)
    adm = AdmissionController(alloc.solution.lengths_int, 64.0,
                              AdmissionConfig(dwell_down=1e9))
    fs = faults.FaultSet(faults.PoolPressure(0.3, 2, 3, seed=8),
                         faults.StragglerDecode(0.25, 3.0, seed=4))
    tracer = Tracer()
    eng = ContinuousBatchingEngine(cfg, params, max_slots=4, capacity=128,
                                   chunk=4, paged=True, block_size=8,
                                   n_blocks=24, tracer=tracer)
    graph_hooks.reset()
    srv = LLMServer(prob, ServerConfig(generate_tokens=True, batch_size=4,
                                       max_extra_tokens=2),
                    engine=eng, allocator=alloc, tracer=tracer,
                    metrics=MetricsRegistry(), admission=adm, faults=fs)
    rep = srv.run(generate_stream(tasks, 2.0 / es, 24, seed=3,
                                  prompt_len_range=(4, 8)))
    assert rep.n_shed > 0 and rep.n + rep.n_shed == 24
    assert all(c.n_tokens == c.budget + 2 for c in srv.completed)
    validate_request_trees(tracer.to_chrome(),
                           [c.rid for c in srv.completed])
    assert graph_hooks.assert_max_captures("continuous.paged", 1) == 1
    fs.release_all(eng)
    assert eng.check_block_invariants()
    assert eng.allocator.n_free == eng.allocator.n_blocks
