"""The launch plans of the prefill flash and the fused FFN kernels
(``kernels/flash_attention.py: flash_plan``, ``kernels/fused_ffn.py:
ffn_plan``).

The plans say, from shapes alone, which route a call takes and how its
work is cut over CTAs. These tests need no card: every folded query row
and every output element is covered exactly once, each route and regime
switches where its source says, the grids cover the SMs at the serve
shapes, shared memory and scratch stay within their bounds at every
main-path shape, and a plan is a function of its shapes only.
"""
import itertools
import math

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_ffn as ff

SMS = 132
SMEM_MAX = 227 * 1024
BF16, F32 = torch.bfloat16, torch.float32

# the main path's prefill shapes: qwen3 (8 kv heads, G 2, hd 128) at the
# serve stream's prompt lengths (18-113), 128 and the padded admission
# groups (B <= 8); zamba2's shared block (32 kv heads, G 1, hd 112)
FLASH_MAIN = ([(1, 8, 2, S, 128) for S in (16, 18, 37, 113, 128)]
              + [(B, 8, 2, 113, 128) for B in (2, 4, 8)]
              + [(1, 32, 1, S, 112) for S in (18, 37, 113)])
# (E, T, d, f): decode at T 1 and 8 slots, prefill at S, 128 and the
# drain's largest admission group (8 x 113), at qwen3's and zamba2's widths
FFN_MAIN = ([(1, T, 1024, 3072) for T in (1, 8, 18, 37, 113, 128, 904)]
            + [(1, T, 3584, 14336) for T in (1, 8, 18, 37, 113)])


@pytest.mark.parametrize("B,H,G,S,hd", FLASH_MAIN + [
    (2, 2, 4, 1, 64), (1, 2, 8, 15, 256), (1, 2, 3, 17, 80),
    (1, 1, 12, 300, 128), (1, 2, 1, 1024, 64)])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_flash_plan_covers_each_row_once(B, H, G, S, hd, dtype):
    """Every (head, query) pair of a (batch, kv head) falls in exactly one
    CTA of the grid, on both routes."""
    plan = fa.flash_plan(B, H, G, S, hd, dtype, SMS)
    assert plan.grid_y == B * H
    cells = [c for x in range(plan.grid_x) for c in plan.cells(x)]
    assert sorted(cells) == sorted(itertools.product(range(G), range(S)))
    assert all(plan.cells(x) for x in range(plan.grid_x))


@pytest.mark.parametrize("hd", [16, 30, 64, 72, 80, 112, 128, 136, 256])
def test_flash_route_switches_where_the_source_says(hd):
    """Tensor cores take bf16 at hd a multiple of 16 up to 256 with rows
    on 16 bytes; f32, other widths and unaligned rows take scalar FMAs."""
    on_tc = hd % 16 == 0
    assert fa.flash_plan(1, 8, 2, 128, hd, BF16, SMS).route == \
        ("tensor_core" if on_tc else "scalar")
    assert fa.flash_plan(1, 8, 2, 128, hd, F32, SMS).route == "scalar"
    assert fa.flash_plan(1, 8, 2, 128, hd, BF16, SMS,
                         aligned=False).route == "scalar"
    if on_tc:
        plan = fa.flash_plan(1, 8, 2, 128, hd, BF16, SMS)
        assert plan.hd_pad == (64 if hd <= 64 else 128 if hd <= 128
                               else 256)
        assert plan.warps * 16 == plan.block_k


@pytest.mark.parametrize("B,H,G,S,hd", FLASH_MAIN)
def test_flash_plan_limits_at_main_path_shapes(B, H, G, S, hd):
    """Shared memory within a CTA's 227 KB on both routes; at hd <= 128
    three tensor-core CTAs an SM of one row tile, two of more (the
    kernel's launch bounds)."""
    for dtype in (BF16, F32):
        plan = fa.flash_plan(B, H, G, S, hd, dtype, SMS)
        assert plan.smem_bytes <= SMEM_MAX
    plan = fa.flash_plan(B, H, G, S, hd, BF16, SMS)
    assert plan.route == "tensor_core"
    per_sm = 3 if plan.row_tiles == 1 else 2
    assert per_sm * plan.smem_bytes <= SMEM_MAX
    assert plan.rows_per_cta == 16 * plan.row_tiles


def test_flash_grid_fills_the_card_at_qwen3_prefill():
    """qwen3's S = 128 prefill gives at least 128 warps of work per SM
    count's worth (the first port ran 64 CTAs), and the padded admission
    group more CTAs than SMs."""
    plan = fa.flash_plan(1, 8, 2, 128, 128, BF16, SMS)
    assert plan.ctas * plan.warps >= 128 * 4
    assert plan.ctas >= 128
    assert fa.flash_plan(8, 8, 2, 113, 128, BF16, SMS).ctas >= SMS
    assert fa.flash_plan(1, 32, 1, 113, 112, BF16, SMS).ctas >= SMS


def _ffn_cover(plan, E, T, d, f):
    """Per GEMM, how many (CTA, split) cover each output element and how
    many splits cover each reduction tile of it."""
    out = {}
    for name, N, K, ks in (("up", f, d, plan.ks_up),
                           ("down", d, f, plan.ks_down)):
        n_tiles = math.ceil(N / ff.TILE_N)
        k_tiles = math.ceil(K / ff.TILE_K)
        assert plan.m_tiles * n_tiles * E == (plan.up_tiles if name == "up"
                                               else plan.down_tiles)
        rows = [r for m in range(plan.m_tiles)
                for r in range(m * plan.bm, min((m + 1) * plan.bm, T))]
        cols = [c for n in range(n_tiles)
                for c in range(n * ff.TILE_N, min((n + 1) * ff.TILE_N, N))]
        ktiles = sorted(t for s in range(ks)
                        for t in ff.split_range(ks, k_tiles, s))
        assert all(len(ff.split_range(ks, k_tiles, s)) > 0
                   for s in range(ks))
        out[name] = (rows, cols, ktiles, k_tiles)
    return out


@pytest.mark.parametrize("E,T,d,f", FFN_MAIN + [
    (2, 1, 1024, 3000), (2, 9, 1024, 3000), (2, 904, 1024, 3000),
    (1, 2, 64, 72), (3, 65, 128, 520)])
def test_ffn_plan_covers_each_element_once(E, T, d, f):
    """Each (row, d_ff column) of h and each (row, d column) of y lies in
    exactly one output tile, and each reduction tile in exactly one
    split of it."""
    plan = ff.ffn_plan(E, T, d, f, BF16, SMS)
    assert plan.route == "tensor_core"
    for name, (rows, cols, ktiles, k_tiles) in _ffn_cover(
            plan, E, T, d, f).items():
        assert rows == list(range(T))
        assert cols == list(range(f if name == "up" else d))
        assert ktiles == list(range(k_tiles))


@pytest.mark.parametrize("T", [1, 2, 8, 9, 16, 17, 37, 64, 65, 904])
def test_ffn_regime_switches_where_the_source_says(T):
    """16-row tiles up to DECODE_MAX_T rows, 64-row tiles beyond; f32,
    widths off the 8-element grid and unaligned operands take the scalar
    kernel."""
    plan = ff.ffn_plan(1, T, 1024, 3072, BF16, SMS)
    decode = T <= ff.DECODE_MAX_T
    assert plan.regime == ("decode" if decode else "prefill")
    assert plan.bm == (16 if decode else 64)
    assert plan.m_tiles == math.ceil(T / plan.bm)
    for args, kw in (((1, T, 1024, 3072, F32, SMS), {}),
                     ((1, T, 1020, 3072, BF16, SMS), {}),
                     ((1, T, 1024, 3068, BF16, SMS), {}),
                     ((1, T, 1024, 3072, BF16, SMS), {"aligned": False})):
        scalar = ff.ffn_plan(*args, **kw)
        assert scalar.route == scalar.regime == "scalar"
        assert scalar.bt >= 1 and scalar.n_split >= 1


@pytest.mark.parametrize("E,T,d,f", FFN_MAIN)
def test_ffn_plan_limits_at_main_path_shapes(E, T, d, f):
    """Shared memory within a CTA's 227 KB (two gate/up CTAs an SM in the
    decode regime); the f32 partials within PARTIAL_SHARE of the weight
    bytes; h's scratch is T d_ff elements; splits within SPLIT_MAX; the
    programmatic dependent launch only in the decode regime."""
    plan = ff.ffn_plan(E, T, d, f, BF16, SMS)
    assert plan.smem_up <= SMEM_MAX and plan.smem_down <= SMEM_MAX
    if plan.regime == "decode":
        assert 2 * plan.smem_up <= SMEM_MAX
    weights = 3 * E * d * f * 2
    assert plan.scratch_bytes <= ff.PARTIAL_SHARE * weights
    assert plan.h_bytes == E * T * f * 2
    assert 1 <= plan.ks_up <= ff.SPLIT_MAX
    assert 1 <= plan.ks_down <= ff.SPLIT_MAX
    assert plan.scratch_bytes == ff.scratch_bytes(E, T, d, f, plan.ks_up,
                                                  plan.ks_down)
    assert not plan.pdl or plan.regime == "decode"
    scalar = ff.ffn_plan(E, T, d, f, F32, SMS)
    assert scalar.smem_up <= SMEM_MAX


@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("d,f", [(1024, 3072), (3584, 14336)])
def test_ffn_grid_covers_the_sms_at_decode(T, d, f):
    """At the serve paths' decode shapes each GEMM launches at least one
    CTA per SM (the first port's qwen3 grid was 96 CTAs)."""
    plan = ff.ffn_plan(1, T, d, f, BF16, SMS)
    assert plan.grid_up >= SMS and plan.grid_down >= SMS


def test_plans_are_functions_of_shapes():
    """The plans take ints and a dtype, read no tensor, and equal shapes
    give equal plans."""
    for args in FLASH_MAIN:
        for dtype in (BF16, F32):
            a = fa.flash_plan(*args, dtype, SMS)
            assert a == fa.flash_plan(*args, dtype, SMS)
            assert isinstance(a, fa.FlashPlan)
    for args in FFN_MAIN:
        for dtype in (BF16, F32):
            a = ff.ffn_plan(*args, dtype, SMS)
            assert a == ff.ffn_plan(*args, dtype, SMS)
            assert isinstance(a, ff.FfnPlan)
