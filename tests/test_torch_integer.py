"""The port's integer projection (Sec III-E) against ``repro.core``.

``coordinate_policy``, ``sandwich`` and ``solve(integer_method=...)`` for
the three methods, on ``paper_problem`` and two perturbed problems:
integer budgets bitwise, values within 1e-12 of the JAX package run
under ``enable_x64`` (outside it the JAX objective runs in f32, where the
coordinate search's ``v > best + 1e-12`` test can take other moves).
Also the delay-SLO projection after each method.
"""
import numpy as np
import pytest

from repro import core as jcore
from repro.compat import enable_x64
from repro_torch import core as tcore
from repro_torch.compat import cap_xdist_threads

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

METHODS = ("exhaustive", "coordinate", "round")
TOL = dict(rel=1e-12, abs=1e-12)


def _problem(core, case: str):
    if case == "paper":
        return core.paper_problem(lam=0.1, alpha=30.0)
    if case == "loaded":
        return core.paper_problem(lam=0.25, alpha=60.0)
    # random task constants from a seed, the same in both packages
    r = np.random.default_rng(7)
    n = 5
    tasks = core.TaskSet(
        names=tuple(f"t{i}" for i in range(n)),
        A=r.uniform(0.3, 0.7, n), b=r.uniform(0.002, 0.02, n),
        D=r.uniform(0.1, 0.3, n), t0=r.uniform(0.2, 1.0, n),
        c=r.uniform(0.002, 0.006, n), pi=np.full(n, 1.0 / n))
    return core.Problem(tasks=tasks, server=core.ServerParams(0.15, 40.0,
                                                              600.0))


CASES = ("paper", "loaded", "random")


def _l_star(case):
    with enable_x64():
        return np.asarray(jcore.solve(_problem(jcore, case)).lengths_cont)


@pytest.mark.parametrize("case", CASES)
def test_coordinate_policy_matches_reference(case):
    l_star = _l_star(case)
    for shift in (0.0, 0.37, -0.61):
        ls = np.clip(l_star + shift, 0.0, None)
        with enable_x64():
            want = jcore.integer.coordinate_policy(_problem(jcore, case), ls)
        got = tcore.integer.coordinate_policy(_problem(tcore, case), ls)
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(want.lengths))
        assert float(got.value) == pytest.approx(float(want.value), **TOL)
        assert got.method == "coordinate"


@pytest.mark.parametrize("case", CASES)
def test_sandwich_matches_reference(case):
    l_star = _l_star(case)
    with enable_x64():
        want = jcore.integer.sandwich(_problem(jcore, case), l_star)
    got = tcore.sandwich(_problem(tcore, case), l_star)
    assert set(got) == set(want)
    for k, v in want.items():
        if k.startswith("l_"):
            np.testing.assert_array_equal(got[k], np.asarray(v))
        else:
            assert got[k] == pytest.approx(v, **TOL), k
    # the ordering of tests/test_core_integer.py
    assert got["J_continuous"] >= got["J_int_exhaustive"] - 1e-9
    assert got["J_int_exhaustive"] >= got["J_int_round"] - 1e-9
    assert got["J_int_coordinate"] >= got["J_int_round"] - 1e-9
    assert got["J_int_round"] >= got["J_bar_lower_bound"] - 1e-9


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", CASES)
def test_solve_integer_method_matches_reference(case, method):
    want = jcore.solve(_problem(jcore, case), integer_method=method)
    got = tcore.solve(_problem(tcore, case), 1e-8, method)
    np.testing.assert_array_equal(got.lengths_int, want.lengths_int)
    assert got.value_int == pytest.approx(want.value_int, **TOL)
    assert got.value_cont == pytest.approx(want.value_cont, **TOL)
    assert got.method == want.method


@pytest.mark.parametrize("method", METHODS)
def test_delay_slo_after_integer_method(method):
    slo = [3.0, 8.0, 3.5, 3.0, 9.0, 4.0]
    want = jcore.solve(jcore.paper_problem(), integer_method=method,
                       delay_slo=slo)
    got = tcore.solve(tcore.paper_problem(), integer_method=method,
                      delay_slo=slo)
    np.testing.assert_array_equal(got.lengths_int, want.lengths_int)
    np.testing.assert_allclose(got.lengths_cont, want.lengths_cont,
                               rtol=1e-12, atol=1e-9)
    assert got.slo_satisfied == want.slo_satisfied
    assert got.method == want.method and got.method.endswith("+slo")
    assert got.value_int == pytest.approx(want.value_int, **TOL)
