"""The Hopper kernels against their plain versions, on the card.

Runs where a CUDA device is (``python -m pytest -q -m cuda
tests/test_torch_cuda.py``) and skips elsewhere; it imports no JAX, so it
runs on a machine without it. Shapes are the serving paths' at
qwen3-0.6b's widths, including ragged prompt lengths, T = 1 and ragged
paged positions. Tolerances: the repo's kernel tolerances (2e-5 f32, 2e-2
bf16), except 1e-4 for the f32 FFN, whose 1024- and 3072-term sums run in
another order than ``torch.matmul``'s. A paged slot with no visible
position (all sentinel) is kept out of the comparison: the kernel gives
it 0 where the plain version, like the TPU kernel, averages a clipped
block; the engine discards such rows.
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
def test_flash_window_matches_plain(cuda_device):
    """The sliding-window mask of the TPU kernel (not on the qwen3 path)."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn(2, 2, 2, 100, 64, generator=g, device=cuda_device)
    k = torch.randn(2, 2, 100, 64, generator=g, device=cuda_device)
    v = torch.randn(2, 2, 100, 64, generator=g, device=cuda_device)
    torch.testing.assert_close(flash_attention(q, k, v, window=24),
                               flash_attention_plain(q, k, v, window=24),
                               rtol=2e-5, atol=2e-5)


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
