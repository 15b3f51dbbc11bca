"""The end-to-end arithmetic and the yardstick's counts, by hand."""
import math

import pytest

from portbench import harness, roofline, stats
from portbench.traffic import Request

import numpy as np


def req(due, reads, done=False, admit=math.nan):
    r = Request(rid=0, task=0, prompt=np.zeros(4, np.int64), due=due)
    r.read_times, r.done, r.admit_start = list(reads), done, admit
    return r


def test_exact_percentiles():
    xs = list(range(1, 11))                       # 1..10
    assert stats.percentile(xs, 90) == pytest.approx(9.1)
    assert stats.percentile(xs, 50) == pytest.approx(5.5)
    assert stats.percentile([3.0], 90) == 3.0
    assert stats.percentile(xs, 90) == pytest.approx(np.percentile(xs, 90))


def test_unfinished_requests_count_at_their_age():
    t_open, t_close = 10.0, 20.0
    done = req(11.0, [11.5, 12.0, 12.5], done=True)
    waiting = req(15.0, [])                       # never admitted
    flying = req(12.0, [13.0, 14.0])              # in flight at the close
    late = req(19.0, [20.5], done=True)           # read after the close
    m = stats.poisson_metrics([done, waiting, flying, late], t_open, t_close)
    ttfts = [0.5, 5.0, 1.0, 1.0]                  # late: its age, 1.0
    assert m["ttft_p90_ms"] == pytest.approx(
        1e3 * stats.percentile(ttfts, 90))
    assert m["system_time_mean_s"] == pytest.approx(
        (1.5 + 5.0 + 8.0 + 1.0) / 4)
    # TPOT: done 0.5 (1.0 over 2 gaps), flying 1.0; the others lack two
    assert m["tpot_p90_ms"] == pytest.approx(
        1e3 * stats.percentile([0.5, 1.0], 90))


def test_requests_due_outside_the_window_are_left_out():
    m = stats.poisson_metrics([req(5.0, [6.0], done=True),
                               req(12.0, [12.2, 12.4], done=True)], 10, 20)
    assert m["ttft_p90_ms"] == pytest.approx(200.0)


def test_token_rate_counts_reads_inside_the_window():
    rs = [req(0.0, [0.5, 1.5, 1.5, 2.5]), req(0.0, [1.0, 3.5])]
    assert stats.tokens_per_s(rs, 1.0, 3.0) == pytest.approx(4 / 2.0)


SPEC = harness.load_json(harness.HERE / "configs" / "deepseek-moe-16b.json")


def test_kv_bytes_per_token():
    assert roofline.kv_bytes_per_token(SPEC) == 28 * 2 * 16 * 128 * 2 \
        == 229376


def test_flops_per_token_by_hand():
    d, f, L = 2048, 1408, 28
    attn = d * (16 + 32) * 128 + 16 * 128 * d      # q, k, v; o
    per_layer = attn + d * 64 + (6 + 2) * 3 * d * f
    assert roofline.layer_matmul_params(SPEC) == per_layer
    # about 5.2 GFLOP a token with the head, before attention
    assert 2 * per_layer * L + 2 * d * 102400 == pytest.approx(5.2e9,
                                                               rel=0.02)
    ctx = 100
    want = 2 * per_layer * L + 4 * 16 * 128 * ctx * L + 2 * d * 102400
    assert roofline.decode_token_flops(SPEC, ctx) == want
    S = 50
    assert roofline.prefill_flops(SPEC, S) == \
        2 * per_layer * L * S + 4 * 16 * 128 * (S * (S + 1) // 2) * L \
        + 2 * d * 102400


def test_kernel_costs_by_hand():
    fl, by = roofline.flash_cost(SPEC, 10)
    assert fl == 28 * 4 * 16 * 128 * 55
    assert by == 28 * 10 * 128 * (32 + 32) * 2
    fl, by = roofline.decode_attention_cost(SPEC, [5, 7])
    assert fl == 28 * 4 * 16 * 128 * 12
    assert by == 28 * (12 * 2 * 16 * 128 + 2 * 2 * 16 * 128) * 2
    assert roofline.bound_s(989.4e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
