"""The mixes: pure functions of the seed, the same work for every seed,
and the budgets the allocation problem gives."""
import collections
import json

import numpy as np
import pytest

from repro_torch.compat import cap_xdist_threads

from portbench import harness, traffic
from portbench.reference import budgets

cap_xdist_threads()

MIXES = ("paper", "deep", "docqa")


def mix(name):
    return harness.load_json(harness.HERE / "mixes" / f"{name}.json")


def key(reqs):
    return [(r.task, r.prompt.tolist(), r.due, r.max_extra) for r in reqs]


@pytest.mark.parametrize("name", MIXES)
def test_mix_is_a_function_of_the_seed(name):
    m = mix(name)
    a = traffic.generate(m, 60, 2**33 + 17, 102400, rate=3.0)
    b = traffic.generate(m, 60, 2**33 + 17, 102400, rate=3.0)
    c = traffic.generate(m, 60, 2**33 + 18, 102400, rate=3.0)
    assert key(a) == key(b)
    assert key(a) != key(c)
    # another seed: the same sizes and gaps, in another order
    assert sorted(r.prompt_len for r in a) == sorted(r.prompt_len for r in c)
    assert collections.Counter(r.task for r in a) \
        == collections.Counter(r.task for r in c)
    gaps = lambda rs: sorted(np.diff([0.0] + [r.due for r in rs]).round(9))
    assert gaps(a) == gaps(c)
    # ... and in the same coarse shape: each block of 6 holds the same
    block = m["order"]["block"]
    for i in range(0, 60, block):
        assert sorted(r.prompt_len for r in a[i:i + block]) \
            == sorted(r.prompt_len for r in c[i:i + block])
        assert sorted(r.task for r in a[i:i + block]) == list(range(6))
    law = m["prompt_len"]
    assert all(law["lo"] <= r.prompt_len <= law["hi"] for r in a)
    assert all(0 <= t < 102400 for r in a for t in r.prompt)


def test_backlog_is_due_at_once_and_types_balance():
    reqs = traffic.generate(mix("deep"), 60, 5, 1000)
    assert all(r.due == 0.0 for r in reqs)
    assert set(collections.Counter(r.task for r in reqs).values()) == {10}


def test_prompt_laws():
    assert traffic.prompt_lengths({"dist": "uniform", "lo": 16, "hi": 128},
                                  113).tolist() == list(range(16, 129))
    x = traffic.prompt_lengths({"dist": "loguniform", "lo": 512,
                                "hi": 3584}, 1000)
    assert x.min() == 512 and 3570 < x.max() <= 3584
    assert 1500 < x.mean() < 1650          # about 1,580
    assert traffic.prompt_lengths({"dist": "loguniform", "lo": 512,
                                   "hi": 3584}, 100000).max() == 3584


@pytest.mark.parametrize("name", MIXES)
def test_budgets_reference_and_allocator(name):
    from repro_torch.core.allocator import TokenBudgetAllocator
    m = mix(name)
    want = m["expected_budgets"]
    assert budgets.integer_budgets(m) == want
    alloc = TokenBudgetAllocator(harness.problem(m))
    assert [alloc.budget_for(k) for k in range(6)] == want


def test_pinned_budgets():
    assert mix("paper")["expected_budgets"] == [0, 341, 0, 0, 346, 30]
    assert mix("docqa")["expected_budgets"] == [0, 341, 0, 0, 346, 30]
    assert mix("deep")["expected_budgets"] == [1325, 987, 1227, 1617, 1452,
                                               43]
    # 127.5 and 1,116.5 tokens out on average with 8 answer tokens
    assert np.mean([b + 8 for b in mix("paper")["expected_budgets"]]) \
        == pytest.approx(127.5)
    assert np.mean([b + 8 for b in mix("deep")["expected_budgets"]]) \
        == pytest.approx(1116.5)


def test_mix_files_parse():
    for name in MIXES:
        json.loads((harness.HERE / "mixes" / f"{name}.json").read_text())
