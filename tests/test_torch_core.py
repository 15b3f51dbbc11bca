"""Control-plane parity: ``repro_torch.core`` against ``repro.core``.

Integer budgets must agree exactly; continuous values to 1e-9 relative
(both packages run the same float64 formulas, so only the last bits of
``exp``/``log`` may differ); the solver path taken must agree.
"""
import numpy as np
import pytest

from repro import core as jcore
from repro.queueing_sim import generate_stream as j_stream
from repro_torch import core as tcore
from repro_torch.queueing_sim import generate_stream as t_stream
from repro_torch.queueing_sim import pk_prediction

REL = 1e-9

# (lam, alpha): a small grid on the fixed-point path, plus (0.4, 60), which
# takes the PGA fallback ("fixed_point+pga") in the reference
GRID = [(0.1, 30.0), (0.05, 10.0), (0.2, 30.0), (0.1, 60.0), (0.3, 5.0),
        (0.4, 60.0)]


def _assert_solution_equal(js, ts):
    np.testing.assert_array_equal(ts.lengths_int, js.lengths_int)
    np.testing.assert_allclose(ts.lengths_cont, js.lengths_cont, rtol=REL,
                               atol=REL)
    for f in ("value_cont", "value_int", "value_lower_bound"):
        assert getattr(ts, f) == pytest.approx(getattr(js, f), rel=REL), f
    assert ts.method == js.method
    assert ts.stable == js.stable


@pytest.mark.parametrize("lam,alpha", GRID)
def test_solve_matches_reference(lam, alpha):
    js = jcore.solve(jcore.paper_problem(lam=lam, alpha=alpha))
    ts = tcore.solve(tcore.paper_problem(lam=lam, alpha=alpha))
    _assert_solution_equal(js, ts)


def test_pga_fallback_is_taken():
    ts = tcore.solve(tcore.paper_problem(lam=0.4, alpha=60.0))
    assert ts.method == "fixed_point+pga"


def test_delay_slo_projection_matches_reference():
    slo = [5.0, 3.0, 5.0, 5.0, 4.0, 2.0]
    js = jcore.solve(jcore.paper_problem(), delay_slo=slo)
    ts = tcore.solve(tcore.paper_problem(), delay_slo=slo)
    _assert_solution_equal(js, ts)
    assert ts.slo_satisfied == js.slo_satisfied


def test_online_allocator_matches_reference():
    """One arrival sequence through both allocators: same re-solves, same
    budgets after every arrival."""
    jp, tp = jcore.paper_problem(), tcore.paper_problem()
    ja = jcore.TokenBudgetAllocator(jp, min_resolve_interval=20)
    ta = tcore.TokenBudgetAllocator(tp, min_resolve_interval=20)
    # a load step: the stream arrives at twice the solved-for rate
    stream = t_stream(tp.tasks, 0.2, 120, seed=5)
    for q in stream.queries:
        ja.observe_arrival(q.task, q.arrival)
        ta.observe_arrival(q.task, q.arrival)
        assert ta.budgets() == ja.budgets()
    assert ta.n_resolves == ja.n_resolves
    assert ta.n_resolves > 1
    js, ts = ja.estimator_state(), ta.estimator_state()
    assert ts["lam"] == pytest.approx(js["lam"], rel=1e-12)
    np.testing.assert_allclose(ts["pi"], js["pi"], rtol=1e-12)


def test_stream_and_prediction_match_reference():
    jp, tp = jcore.paper_problem(), tcore.paper_problem()
    js = j_stream(jp.tasks, 0.1, 50, seed=3)
    ts = t_stream(tp.tasks, 0.1, 50, seed=3)
    assert ts.queries == tuple(
        type(ts.queries[0])(**vars(q)) for q in js.queries)
    assert ts.horizon == js.horizon
    from repro.compat import enable_x64
    from repro.queueing_sim import pk_prediction as j_pk
    budgets = [0, 341, 0, 0, 346, 30]
    with enable_x64():     # the reference is float32 unless asked for x64
        jpred = j_pk(jp, budgets)
    tpred = pk_prediction(tp, budgets)
    for k, v in jpred.items():
        assert tpred[k] == pytest.approx(v, rel=1e-12), k


def test_lambertw_matches_reference():
    import torch

    from repro.compat import enable_x64
    z = np.concatenate([[0.0], np.logspace(-8, 250, 60)])
    with enable_x64():
        jw = np.asarray(jcore.lambertw0(np.asarray(z)))
    tw = tcore.lambertw0(torch.as_tensor(z, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(tw, jw, rtol=1e-12, atol=0)
