"""The port's ``Scheduler`` under all six disciplines against
``repro.serving.scheduler`` on one admission trajectory: the same keys in
the admission heap, bitwise, and the same service order. The predicted
disciplines draw their per-admission noise from
``default_rng((predictor.seed, predictor_seed))`` in both packages.
"""
import numpy as np
import pytest

from repro import core as jcore
from repro import serving as jserving
from repro.data.predictor import LengthPredictor as JPredictor
from repro_torch import core as tcore
from repro_torch import serving as tserving
from repro_torch.data.predictor import LengthPredictor as TPredictor
from repro_torch.queueing_sim import ALL_DISCIPLINES

ADMISSIONS = [(1, None), (4, None), (5, 7), (0, None), (1, 400), (4, 0),
              (5, None), (2, None), (3, 50), (1, None)]


def _trajectory(core, sv, discipline, predictor, seed):
    alloc = core.TokenBudgetAllocator(core.paper_problem())
    sched = sv.Scheduler(alloc, discipline, predictor=predictor,
                         predictor_seed=seed)
    for i, (task, cap) in enumerate(ADMISSIONS):
        sched.admit(sv.Request(rid=i, task_index=task, prompt=np.arange(4),
                               arrival_t=float(i)), float(i), budget_cap=cap)
    keys = sorted((float(k), s, r.rid) for k, s, r in sched._heap)
    order = []
    while len(sched):
        r = sched.next_request()
        order.append((r.rid, r.budget))
    return keys, order


@pytest.mark.parametrize("sigma,seed", [(0.0, 0), (0.8, 3)])
@pytest.mark.parametrize("discipline", ALL_DISCIPLINES)
def test_scheduler_keys_and_order_match_reference(discipline, sigma, seed):
    kw = dict(kind="oracle", sigma=sigma, seed=5)
    want = _trajectory(jcore, jserving, discipline,
                       JPredictor(**kw) if sigma else None, seed)
    got = _trajectory(tcore, tserving, discipline,
                      TPredictor(**kw) if sigma else None, seed)
    assert got == want
    if discipline in ("spjf", "sprpt") and sigma:
        # noisy keys: not the true service times of the SRPT order
        assert got[0] != _trajectory(tcore, tserving, "srpt", None, 0)[0]


def test_scheduler_refuses_unknown_discipline():
    alloc = tcore.TokenBudgetAllocator(tcore.paper_problem())
    with pytest.raises(ValueError, match="unknown discipline"):
        tserving.Scheduler(alloc, "lifo")


@pytest.mark.parametrize("discipline", ["spjf", "srpt", "sprpt"])
def test_launcher_serves_every_discipline(discipline, capsys):
    """``launch/serve.py --discipline`` takes all six (virtual clock)."""
    from repro_torch.launch import serve

    rep = serve.main(["--queries", "40", "--lam", "0.3",
                      "--discipline", discipline, "--device", "cpu"])
    assert rep["n"] == 40
    assert '"n": 40' in capsys.readouterr().out
