"""The split plan of the decode kernels (``kernels/decode_attention.py``).

The kernels split each (batch, kv head) row's KV walk across CTAs; the
plan says how, from shapes alone. These tests need no card: they check
that every tile is walked exactly once, that ``n_split`` stays within the
merge's scratch limit, that the plan is a function of shapes only (it
takes no tensor, and equal shapes give equal plans), and that a short
prefix of a long cache is spread over several splits at batch 1.
"""
import itertools
import math

import pytest
import torch

from repro_torch.kernels.decode_attention import (SPLIT_MAX, SplitPlan,
                                                  split_plan)
from repro_torch.compat import cap_xdist_threads

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

GRID = list(itertools.product(
    [1, 2, 8, 32],                          # B
    [1, 8, 32],                             # nkv
    [(64, None), (2048, None), (2047, None), (2048, 16), (2048, 48),
     (4096, 128), (96, 3)],                 # (positions, paged block size)
    [16, 64, 112, 128, 256],                # hd
    [torch.bfloat16, torch.float32],
    [1, 114, 132]))                         # SMs


@pytest.mark.parametrize("B,nkv,pos_bs,hd,dtype,sms", GRID[::20])
def test_every_tile_walked_once(B, nkv, pos_bs, hd, dtype, sms):
    n_pos, bs = pos_bs
    plan = split_plan(B, nkv, n_pos, hd, dtype, sms, block_size=bs)
    assert plan.n_tiles == math.ceil(n_pos / plan.tile)
    walked = sorted(t for s in range(plan.n_split) for t in plan.tiles(s))
    assert walked == list(range(plan.n_tiles))
    assert all(len(plan.tiles(s)) > 0 for s in range(plan.n_split))


def test_plan_limits_over_the_grid():
    """n_split within 1..SPLIT_MAX and the tile count; the tile at most
    the kernel's 128 rows, a whole number of blocks unless a block is
    larger than a tile, and at most 64 KB of K and V rows a stage, so two
    stages fit the CTA's shared memory."""
    for B, nkv, (n_pos, bs), hd, dtype, sms in GRID:
        plan = split_plan(B, nkv, n_pos, hd, dtype, sms, block_size=bs)
        assert 1 <= plan.n_split <= min(SPLIT_MAX, plan.n_tiles)
        assert 1 <= plan.tile <= 128
        el = torch.finfo(dtype).bits // 8
        assert 2 * plan.tile * hd * el <= 64 * 1024
        if bs is not None:
            assert plan.tile % bs == 0 or plan.tile < bs


def test_plan_is_a_function_of_shapes():
    """The plan takes only ints and a dtype, reads no tensor, and is the
    same on every call with the same shapes."""
    for B, nkv, (n_pos, bs), hd, dtype, sms in GRID[::5]:
        a = split_plan(B, nkv, n_pos, hd, dtype, sms, block_size=bs)
        b = split_plan(B, nkv, n_pos, hd, dtype, sms, block_size=bs)
        assert a == b and isinstance(a, SplitPlan)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nkv,hd", [(8, 128), (32, 112)])
def test_batch1_prefix_spreads_over_splits(dtype, nkv, hd):
    """The batch-1 serve decodes at positions 18-460 of a 2048-slot
    cache: a 128-position prefix must land on more than one split."""
    plan = split_plan(1, nkv, 2048, hd, dtype, 132)
    owners = {s for s in range(plan.n_split) for t in plan.tiles(s)
              if t * plan.tile < 128}
    assert len(owners) > 1


@pytest.mark.parametrize("B", [1, 2, 4, 8])
@pytest.mark.parametrize("bs", [None, 16])
def test_serve_shapes_split_the_walk(B, bs):
    """At C (or n_bt * bs) 2048 and batch <= 8, qwen3's and zamba2's
    shapes launch more than one CTA per (batch, kv head)."""
    for nkv, hd in ((8, 128), (32, 112)):
        plan = split_plan(B, nkv, 2048, hd, torch.bfloat16, 132,
                          block_size=bs)
        assert plan.n_split > 1
