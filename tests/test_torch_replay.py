"""The closed loop in the port against ``repro``'s: the online estimators,
the drift monitor and the trace-replay harness.

The estimators and the monitor are NumPy in both packages, and the
harness's queueing passes are too, so on the same NumPy-seeded traces the
port is held bitwise: the same observation blocks give identical
``EstimatorState`` and ``DriftReport`` dicts, and a replay deploys the
same integer budgets in every block (its re-solves run
``repro_torch.sweeps.solve_grid`` with ``device="cpu"`` against the JAX
package's under its own ``enable_x64``), re-solves as often, and gives
bitwise the reference's waits, services, budgets, correctness draws,
estimator states, admission snapshot, drift history and tracer events.
That holds for FIFO under the blind cadence, for SJF and for SPJF with a
noisy ``LengthPredictor``, and for the drift mode with admission, four
fault injectors, a tracer and a metrics registry. ``predicted`` and the
report's P-K side run through torch float64 in the port, so they are held
at 1e-12.

The reference's contract tests run on the port as well: the estimator
and monitor unit cases, the CRN pin against ``lindley_numpy``, block-carry
exactness, convergence to the oracle without oracle parameters, the drift
response, the replay report, the fault cases (NaN corruption, an engine
failure mid-block, the overload drill) and the discipline cases. The
engine lane runs reduced ``qwen3-0.6b`` (``d_model=64``, the JAX
package's parameters) through ``DecodeEngine``; its services are wall
clock, so only its structure is checked.

About 35 s alone in one process on an 8-core CPU host (the JAX package's
``solve_grid`` compiles once per cell count, 1 and 3 here).
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import faults as jfaults
from repro import queueing_sim as jqs
from repro import serving as jserving
from repro.compat import enable_x64
from repro.configs import get_config as j_get_config
from repro.data import LengthPredictor as JLengthPredictor
from repro.models import init_params as j_init_params
from repro.models import reduced as j_reduced
from repro.obs import monitor as jmonitor
from repro.obs import trace as jtrace
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry
from repro.serving import estimators as jest
from repro_torch import core as tcore
from repro_torch import faults as tfaults
from repro_torch import queueing_sim as tqs
from repro_torch import serving as tserving
from repro_torch.configs import get_config
from repro_torch.core.allocator import solve
from repro_torch.data import LengthPredictor
from repro_torch.models import reduced
from repro_torch.obs import graph_hooks
from repro_torch.obs import monitor as tmonitor
from repro_torch.obs import trace as ttrace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.queueing_sim.batched import lindley_numpy
from repro_torch.queueing_sim.disciplines import windowed_start_finish
from repro_torch.serving import estimators as est_t
from repro_torch.weights import from_jax_params
from repro_torch.compat import cap_xdist_threads

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

# ~ the paper's Table I l* (as in tests/test_prediction.py)
LSTAR = np.array([0.0, 340.0, 0.0, 0.0, 345.0, 30.0])


@pytest.fixture(scope="module")
def prob():
    return tcore.paper_problem()


@pytest.fixture(scope="module")
def jprob():
    return jcore.paper_problem()


@pytest.fixture(scope="module")
def oracle_lengths(prob):
    return np.asarray(solve(prob).lengths_int, dtype=np.int64)


def harness(problem, cfg=None, **kw):
    return tserving.ReplayHarness(problem, cfg, device="cpu", **kw)


def traces(tprob, jprob, segments, seed, **kw):
    """The same drift trace from each package's generator (bitwise)."""
    t = tqs.generate_drift_trace(
        tprob.tasks, [tqs.Segment(n, lam) for n, lam in segments], seed=seed,
        **kw)
    j = jqs.generate_drift_trace(
        jprob.tasks, [jqs.Segment(n, lam) for n, lam in segments], seed=seed,
        **kw)
    np.testing.assert_array_equal(t.arrivals, j.arrivals)
    np.testing.assert_array_equal(t.types, j.types)
    return t, j


def assert_same_result(t, j):
    """Every array of two ReplayResults bitwise, every block record equal
    (NaN equal to NaN), the same number of re-solves."""
    for f in ("arrivals", "types", "budgets", "services", "waits",
              "system_times", "correct", "accuracy_prob", "final_budgets",
              "served"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f, strict=True)
    assert t.n_resolves == j.n_resolves
    assert t.mode == j.mode
    assert len(t.blocks) == len(j.blocks)
    for bt, bj in zip(t.blocks, j.blocks):
        np.testing.assert_equal(dataclasses.asdict(bt),
                                dataclasses.asdict(bj))
    np.testing.assert_equal(t.estimator_state, j.estimator_state)
    np.testing.assert_equal(t.admission, j.admission)


def _no_wall_clock(trace: dict) -> list:
    """The events with the wall clock's timestamps and durations taken
    out (virtual-timeline events keep theirs)."""
    out = []
    for ev in trace["traceEvents"]:
        ev = dict(ev)
        if ev.get("pid") == ttrace.WALL_PID:
            ev.pop("ts", None)
            ev.pop("dur", None)
        out.append(ev)
    return out


def _plain(snapshot: dict) -> dict:
    """A registry snapshot with each package's dataclasses as dicts."""
    return {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
            for k, v in snapshot.items()}


# ============================================================ estimators
def test_ewma_batch_equals_sequential():
    rng = np.random.default_rng(0)
    x = rng.normal(size=500)
    a = est_t._EwmaMean(halflife=64.0)
    a.update(x)
    b = est_t._EwmaMean(halflife=64.0)
    for v in x:
        b.update([v])
    assert a.mean == pytest.approx(b.mean, rel=1e-12)
    c = est_t._EwmaMean(halflife=64.0)
    for chunk in np.array_split(x, 7):
        c.update(chunk)
    assert c.mean == pytest.approx(a.mean, rel=1e-12)


@pytest.mark.parametrize("mode", ["ewma", "window"])
def test_rate_estimator_converges(mode):
    lam = 0.37
    rng = np.random.default_rng(1)
    ts = np.cumsum(rng.exponential(1.0 / lam, size=50_000))
    est = est_t.RateEstimator(halflife=4096.0, mode=mode, window=16_384)
    for chunk in np.array_split(ts, 100):
        est.observe_arrivals(chunk)
    assert est.lam == pytest.approx(lam, rel=0.06)


def test_rate_estimator_survives_tiny_gap():
    rng = np.random.default_rng(2)
    ts = np.cumsum(rng.exponential(1.0, size=5000))
    est = est_t.RateEstimator(halflife=1024.0)
    est.observe_arrivals(ts)
    before = est.lam
    est.observe(float(ts[-1]) + 1e-15)
    assert est.lam == pytest.approx(before, rel=0.01)
    assert est.lam == pytest.approx(1.0, rel=0.2)


def test_rate_estimator_tracks_drift_step():
    rng = np.random.default_rng(3)
    t1 = np.cumsum(rng.exponential(1.0 / 0.1, size=8000))
    t2 = t1[-1] + np.cumsum(rng.exponential(1.0 / 0.4, size=8000))
    est = est_t.RateEstimator(halflife=1024.0)
    est.observe_arrivals(t1)
    assert est.lam == pytest.approx(0.1, rel=0.1)
    est.observe_arrivals(t2)
    assert est.lam == pytest.approx(0.4, rel=0.1)


@pytest.mark.parametrize("mode", ["ewma", "window"])
def test_mixture_estimator_converges(mode):
    pi = np.array([0.5, 0.3, 0.15, 0.05])
    rng = np.random.default_rng(4)
    types = rng.choice(4, size=40_000, p=pi)
    est = est_t.MixtureEstimator(4, halflife=8192.0, mode=mode,
                                 window=32_768)
    for chunk in np.array_split(types, 50):
        est.observe_types(chunk)
    assert np.max(np.abs(est.pi - pi)) < 0.02


def test_service_moment_estimator_and_pk():
    rng = np.random.default_rng(5)
    s = np.where(rng.random(60_000) < 0.5, 1.0, 3.0)
    est = est_t.ServiceMomentEstimator(halflife=16_384.0)
    est.observe_services(s)
    assert est.es == pytest.approx(2.0, rel=0.02)
    assert est.es2 == pytest.approx(5.0, rel=0.02)
    lam = 0.3
    expect = lam * est.es2 / (2 * (1 - lam * est.es))
    assert est.pk_wait(lam) == pytest.approx(expect, rel=1e-12)
    assert est.pk_wait(1.0) == math.inf


def test_latency_calibrator_exact_recovery():
    t0_true, c_true = np.array([0.1, 0.2]), np.array([0.01, 0.03])
    cal = est_t.LatencyCalibrator(2, halflife=512.0)
    types = np.array([0, 0, 1, 1, 0, 1])
    budgets = np.array([100, 200, 50, 150, 100, 50])
    cal.observe(types, budgets, t0_true[types] + c_true[types] * budgets)
    t0, c, ident = cal.params()
    assert ident.all()
    np.testing.assert_allclose(t0, t0_true, rtol=1e-9)
    np.testing.assert_allclose(c, c_true, rtol=1e-9)


def test_latency_calibrator_prior_until_identified():
    cal = est_t.LatencyCalibrator(1, t0_prior=0.1, c_prior=0.01)
    t0, c, ident = cal.params()
    assert not ident[0] and t0[0] == 0.1 and c[0] == 0.01
    cal.observe([0, 0], [50, 50], [0.6, 0.6])
    t0, c, ident = cal.params()
    assert not ident[0] and c[0] == 0.01
    assert t0[0] == pytest.approx(0.6 - 0.01 * 50)


def test_online_estimators_state_snapshot():
    est = est_t.OnlineEstimators(3)
    st = est.state()
    assert math.isnan(st.lam) and st.n_services == 0
    est.observe_block(np.array([1.0, 2.5, 3.0, 4.2]), np.array([0, 1, 2, 1]),
                      np.array([10, 20, 30, 20]),
                      np.array([0.2, 0.4, 0.6, 0.4]))
    st = est.state()
    assert st.n_arrivals == 4 and st.n_services == 4
    assert st.lam > 0 and st.es > 0 and st.es2 >= st.es ** 2 * 0.99
    d = st.as_dict()
    json.dumps(d)
    assert set(d) >= {"lam", "pi", "es", "es2", "rho", "pk_wait",
                      "t0", "c", "identified", "n_arrivals", "n_services"}


def test_one_nan_does_not_move_estimates():
    """Folding a batch with invalid rows is exactly folding the filtered
    batch, and the skips are counted (``tests/test_faults.py``'s case)."""
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.exponential(1.0, 64))
    k = rng.integers(0, 6, 64)
    l = rng.integers(10, 400, 64).astype(np.float64)
    s = rng.exponential(1.0, 64) + 0.01
    clean, dirty = est_t.OnlineEstimators(6), est_t.OnlineEstimators(6)
    clean.observe_block(t[:32], k[:32], l[:32], s[:32])
    dirty.observe_block(t[:32], k[:32], l[:32], s[:32])
    s_bad = s[32:].copy()
    s_bad[[3, 7]] = [np.nan, -1.0]
    keep = np.ones(32, dtype=bool)
    keep[[3, 7]] = False
    clean.observe_block(t[32:][keep], k[32:][keep], l[32:][keep],
                        s[32:][keep])
    dirty.observe_block(t[32:], k[32:], l[32:], s_bad)
    sc, sd = clean.state(), dirty.state()
    assert sd.es == sc.es and sd.es2 == sc.es2
    np.testing.assert_array_equal(sd.t0, sc.t0)
    np.testing.assert_array_equal(sd.c, sc.c)
    assert np.isfinite(sd.rho) and sd.n_skipped == 4
    dirty.rate.observe_arrivals([np.nan, np.inf])
    dirty.mixture.observe_types([99, -1])
    assert dirty.rate.n_skipped == 2 and dirty.mixture.n_skipped == 2


def _dirty_blocks(seed: int, n_blocks: int = 12, n_tasks: int = 4):
    """Observation blocks of ragged sizes with every kind of invalid row
    the guards skip (NaN/Inf stamps, an out-of-order stamp, NaN, zero and
    negative services, out-of-range types, negative budgets)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    for b in range(n_blocks):
        m = int(rng.integers(0 if b == 3 else 1, 40))
        a = t + np.cumsum(rng.exponential(2.0, m))
        t = float(a[-1]) if m else t
        k = rng.integers(0, n_tasks, m)
        l = rng.integers(0, 300, m).astype(np.float64)
        s = 0.1 + 0.01 * l + rng.exponential(0.05, m)
        if m > 6:
            a[1] = np.nan
            a[4] = a[3] - 0.5
            s[2], s[5] = np.nan, -0.1
            s[0] = 0.0 if b % 2 else np.inf
            k[3] = n_tasks + b % 3
            l[6] = -4.0
        yield a, k, l, s


@pytest.mark.parametrize("mode", ["ewma", "window"])
def test_estimator_states_bitwise(mode):
    """The same blocks give identical states after every block, each
    estimator's own readings too."""
    kw = dict(halflife=37.0, mode=mode, window=50)
    tb = est_t.OnlineEstimators(4, **kw)
    jb = jest.OnlineEstimators(4, **kw)
    np.testing.assert_equal(tb.state().as_dict(), jb.state().as_dict())
    for blk in _dirty_blocks(11):
        tb.observe_block(*blk)
        jb.observe_block(*blk)
        np.testing.assert_equal(tb.state().as_dict(), jb.state().as_dict())
        assert tb.rate.lam == jb.rate.lam and tb.rate.gap == jb.rate.gap
        np.testing.assert_array_equal(tb.mixture.pi, jb.mixture.pi)
        assert tb.moments.pk_wait(0.5) == jb.moments.pk_wait(0.5)
        for x, y in zip(tb.latency.params(), jb.latency.params()):
            np.testing.assert_array_equal(x, y)
    assert tb.state().n_skipped > 0
    assert tb.state().pk_wait == jb.state().pk_wait
    # the allocator's convention: unknown origin drops the first stamp
    tr = est_t.RateEstimator(t_origin=None, mode=mode, window=50)
    jr = jest.RateEstimator(t_origin=None, mode=mode, window=50)
    for ts in ([3.0], [4.0, 4.5], [np.nan, 7.0, 6.0, 9.0]):
        tr.observe_arrivals(ts)
        jr.observe_arrivals(ts)
        assert (tr.lam, tr.n, tr.n_skipped) == (jr.lam, jr.n, jr.n_skipped)


def test_estimator_bad_arguments_raise_alike():
    for cls_t, cls_j in ((est_t._EwmaMean, jest._EwmaMean),
                         (est_t._WindowMean, jest._WindowMean)):
        for mod_cls in (cls_t, cls_j):
            with pytest.raises(ValueError):
                mod_cls(0)
    for mod in (est_t, jest):
        with pytest.raises(ValueError, match="unknown estimator mode"):
            mod.OnlineEstimators(2, mode="median")


# =============================================================== monitor
def _mm1_waits(rng, lam, mu, n):
    """Exact Lindley recursion waits of an M/M/1 sample path."""
    a = rng.exponential(1.0 / lam, n)
    s = rng.exponential(1.0 / mu, n)
    w = np.empty(n)
    w[0] = 0.0
    for i in range(1, n):
        w[i] = max(w[i - 1] + s[i - 1] - a[i], 0.0)
    return w


def _state(lam, mu, c=1):
    es = 1.0 / mu
    return {"lam": lam, "es": es, "es2": 2.0 * es * es, "c_servers": c}


def test_predicted_wait_quantile_closed_form():
    rho, w = 0.8, 2.0
    q = tmonitor.predicted_wait_quantile
    assert q(10.0, w, rho) == 0.0
    assert q(90.0, w, rho) == pytest.approx((w / rho) * math.log(rho / 0.1))
    assert q(90.0, w, 0.0) == 0.0 and q(90.0, 0.0, rho) == 0.0
    for args in ((10.0, w, rho), (90.0, w, rho), (99.9, 0.3, 0.95),
                 (50.0, 1.0, 0.2)):
        assert q(*args) == jmonitor.predicted_wait_quantile(*args)


def test_quiet_on_matched_mm1():
    rng = np.random.default_rng(0)
    mon = tmonitor.DriftMonitor(rel_tol=0.25, patience=2, min_samples=64)
    state = _state(0.6, 1.0)
    waits = _mm1_waits(rng, 0.6, 1.0, 30_000)
    for chunk in np.array_split(waits[5_000:], 5):
        mon.observe(chunk)
        rep = mon.check(state)
        assert not rep.fired and rep.reason == "ok"
    assert rep.rel_err < 0.15


def test_fires_after_patience_on_mismatch():
    rng = np.random.default_rng(1)
    mon = tmonitor.DriftMonitor(rel_tol=0.25, patience=2, min_samples=64)
    stale = _state(0.3, 1.0)
    mon.observe(_mm1_waits(rng, 0.8, 1.0, 4000))
    r1 = mon.check(stale)
    assert not r1.fired and r1.strikes == 1
    mon.observe(_mm1_waits(rng, 0.8, 1.0, 4000))
    r2 = mon.check(stale)
    assert r2.fired and r2.reason == "drift" and r2.strikes == 2
    assert isinstance(r2, tmonitor.DriftReport)
    assert r2.as_dict()["fired"] is True
    mon.note_resolve()
    r3 = mon.check(stale)
    assert r3.reason == "insufficient-data" and r3.strikes == 0
    assert len(mon.history) == 3


def test_insufficient_data_never_fires():
    mon = tmonitor.DriftMonitor(min_samples=64, patience=1, rel_tol=0.01)
    mon.observe(np.ones(10))
    rep = mon.check(_state(0.8, 1.0))
    assert not rep.fired and rep.reason == "insufficient-data"
    assert rep.n == 10


def test_cold_and_unstable_states_predict_zero():
    mon = tmonitor.DriftMonitor(min_samples=1)
    mon.observe(np.ones(5))
    rep = mon.check({"lam": None, "es": None, "es2": None})
    assert rep.predicted_wait == 0.0 and np.isfinite(rep.rel_err)
    rep = mon.check(_state(2.0, 1.0))
    assert rep.predicted_wait == 0.0 and rep.rho == pytest.approx(2.0)


def test_multiserver_prediction_uses_lee_longton():
    mon = tmonitor.DriftMonitor(min_samples=1)
    mon.observe(np.ones(5))
    rep = mon.check(_state(1.5, 1.0, c=2))
    assert rep.predicted_wait > 0.0 and rep.rho == pytest.approx(0.75)


@pytest.mark.parametrize("gate_tail", [False, True])
def test_drift_reports_bitwise(gate_tail):
    """The same waits and states give identical reports, strikes, alarms,
    overload counts and histories, M/G/1 and the Lee-Longton M/G/c."""
    kw = dict(rel_tol=0.2, patience=2, min_samples=32, q=95.0,
              gate_tail=gate_tail, rho_alarm=0.7)
    tm, jm = tmonitor.DriftMonitor(**kw), jmonitor.DriftMonitor(**kw)
    rng = np.random.default_rng(7)
    states = [_state(0.3, 1.0), _state(0.8, 1.0), _state(1.5, 1.0, c=2),
              _state(2.4, 1.0, c=3), {"lam": None, "es": 0.5, "es2": None},
              _state(0.75, 1.0), _state(5.0, 1.0, c=4)]
    for i in range(21):
        w = _mm1_waits(rng, 0.75, 1.0, int(rng.integers(5, 400)))
        w[:3] = 0.0
        tm.observe(w)
        jm.observe(w)
        st = states[i % len(states)]
        assert tm.check(st).as_dict() == jm.check(st).as_dict()
        if i % 6 == 5:
            tm.note_resolve()
            jm.note_resolve()
    assert [r.as_dict() for r in tm.history] == \
        [r.as_dict() for r in jm.history]
    assert tm.n_overloads == jm.n_overloads > 0
    assert any(r.fired for r in tm.history)


def test_replay_drift_mode_resolves_on_evidence(prob):
    trace = tqs.generate_drift_trace(
        prob.tasks, [tqs.Segment(1200, 0.2), tqs.Segment(1200, 0.45)], seed=7)
    res_cad = harness(prob, tserving.ReplayConfig(block_size=64)) \
        .run_virtual(trace)
    res_dft = harness(prob, tserving.ReplayConfig(
        block_size=64, resolve_mode="drift")).run_virtual(trace)
    assert res_dft.n_resolves >= 1
    assert res_dft.n_resolves < res_cad.n_resolves
    reports = [b.drift for b in res_dft.blocks if b.drift is not None]
    assert reports
    assert {"fired", "reason", "rel_err", "rho"} <= set(reports[-1])
    assert res_dft.report(prob).drift == reports[-1]


# =============================================== replay against reference
@pytest.fixture(scope="module")
def fifo_pair(prob, jprob):
    """The reference's convergence run (20,000 requests at lambda 0.1,
    seed 7, blocks of 512) through both packages."""
    t, j = traces(prob, jprob, [(20_000, prob.server.lam)], 7)
    return (harness(prob, tserving.ReplayConfig(block_size=512))
            .run_virtual(t),
            jserving.ReplayHarness(jprob, jserving.ReplayConfig(
                block_size=512)).run_virtual(j))


def test_replay_fifo_matches_reference(fifo_pair):
    tres, jres = fifo_pair
    assert tres.n_resolves > 10
    assert_same_result(tres, jres)


def test_closed_loop_converges_to_oracle(fifo_pair, prob, oracle_lengths):
    res = fifo_pair[0]
    assert res.n_resolves > 10
    assert np.max(np.abs(res.final_budgets - oracle_lengths)) <= 16
    est = res.estimator_state
    assert est["lam"] == pytest.approx(prob.server.lam, rel=0.1)
    np.testing.assert_allclose(est["c"], np.asarray(prob.tasks.c),
                               rtol=0.05)


@pytest.mark.parametrize("discipline", ["sjf", "spjf"])
def test_replay_discipline_matches_reference(prob, jprob, discipline):
    """A non-FIFO closed loop (SJF; SPJF ordered by a noisy predictor):
    the same blocks, re-solves, keys and waits."""
    t, j = traces(prob, jprob, [(2500, 0.25)], 19)
    kw = dict(block_size=128, discipline=discipline, est_halflife=256.0)
    tpred = jpred = None
    if discipline == "spjf":
        tpred = LengthPredictor(sigma=0.8, seed=3)
        jpred = JLengthPredictor(sigma=0.8, seed=3)
    tres = harness(prob, tserving.ReplayConfig(predictor=tpred, **kw)) \
        .run_virtual(t)
    jres = jserving.ReplayHarness(jprob, jserving.ReplayConfig(
        predictor=jpred, **kw)).run_virtual(j)
    assert tres.n_resolves > 5
    assert_same_result(tres, jres)


def _drill(pkg, problem, oracle, trace, tracer, metrics, **kw):
    """The reference's overload drill: an 8x arrival burst, stragglers,
    NaN and dropped observations, the degradation ladder, drift mode."""
    serving, faults = pkg
    adm = serving.AdmissionController(
        oracle, problem.server.l_max,
        serving.AdmissionConfig(rho_high=0.85, rho_low=0.6,
                                dwell_down=800.0))
    fs = faults.FaultSet(faults.ArrivalBurst(8000.0, 20_000.0, 8.0),
                         faults.StragglerDecode(0.02, 2.0, seed=1),
                         faults.ObservationCorruption(0.02, "nan", seed=2),
                         faults.DroppedCompletions(0.02, seed=3))
    h = serving.ReplayHarness(
        problem, serving.ReplayConfig(block_size=256, resolve_mode="drift",
                                      est_halflife=128.0),
        admission=adm, faults=fs, tracer=tracer, metrics=metrics, **kw)
    return h, h.run_virtual(trace)


@pytest.fixture(scope="module")
def drill(prob, jprob, oracle_lengths):
    """Paper problem re-rated to rho = 0.6 at the oracle budgets (as in
    ``tests/test_faults.py``), drilled through both packages with a
    tracer and a metrics registry attached."""
    es = float(np.sum(np.asarray(prob.tasks.pi)
                      * (np.asarray(prob.tasks.t0)
                         + np.asarray(prob.tasks.c) * oracle_lengths)))
    tp2 = dataclasses.replace(
        prob, server=dataclasses.replace(prob.server, lam=0.6 / es))
    jp2 = dataclasses.replace(
        jprob, server=dataclasses.replace(jprob.server, lam=0.6 / es))
    toracle = np.asarray(solve(tp2).lengths_int, dtype=np.int64)
    joracle = np.asarray(jcore.solve(jp2).lengths_int, dtype=np.int64)
    np.testing.assert_array_equal(toracle, joracle)
    t, j = traces(tp2, jp2, [(10_000, tp2.server.lam)], 13)
    ttr, jtr = ttrace.Tracer(), jtrace.Tracer()
    tmet, jmet = MetricsRegistry(), JMetricsRegistry()
    th, tres = _drill((tserving, tfaults), tp2, toracle, t, ttr, tmet,
                      device="cpu")
    jh, jres = _drill((jserving, jfaults), jp2, joracle, j, jtr, jmet)
    return dict(prob=tp2, jprob=jp2, oracle=toracle, tres=tres, jres=jres,
                th=th, jh=jh, ttr=ttr, jtr=jtr, tmet=tmet, jmet=jmet)


def test_drift_admission_faults_match_reference(drill):
    """Drift mode with the ladder, four injectors, tracer and metrics:
    the same results, drift history, ladder snapshot, trace events
    (wall-clock stamps aside) and histograms."""
    tres, jres = drill["tres"], drill["jres"]
    assert_same_result(tres, jres)
    assert [b.drift for b in tres.blocks] == [b.drift for b in jres.blocks]
    assert [r.as_dict() for r in drill["th"].monitor.history] == \
        [r.as_dict() for r in drill["jh"].monitor.history]
    assert tres.admission == jres.admission
    assert _no_wall_clock(drill["ttr"].to_chrome()) == \
        _no_wall_clock(drill["jtr"].to_chrome())
    assert _plain(drill["tmet"].snapshot()) == _plain(drill["jmet"].snapshot())
    np.testing.assert_equal(
        dataclasses.asdict(tres.report(drill["prob"])),
        dataclasses.asdict(jres.report(drill["jprob"])))


def test_burst_with_admission_recovers(drill):
    """The reference's chaos assertions on the port's drill."""
    res, prob2, oracle2 = drill["tres"], drill["prob"], drill["oracle"]
    assert (res.budgets >= 0).all()
    assert (res.budgets <= prob2.server.l_max).all()
    assert max(b.level for b in res.blocks) >= 1
    assert res.admission["level"] == 0
    occ = res.admission["occupancy"]
    assert occ[0] > 0.8 and sum(occ[j] for j in occ if j > 0) > 0.0
    a, sm = res.arrivals, res.served_mask()
    tail = (a >= a[-1] - 4000.0) & sm
    burst = (a >= 8000.0) & (a <= 10_500.0) & sm
    assert res.waits[tail].mean() < 0.1 * res.waits[burst].mean()
    assert np.max(np.abs(res.final_budgets - oracle2)) <= 32
    assert res.estimator_state["lam"] == pytest.approx(prob2.server.lam,
                                                       rel=0.15)
    rep = res.report(prob2)
    assert rep.goodput > 0 and np.isfinite(rep.goodput)
    assert rep.degradation_occupancy["0"] == pytest.approx(occ[0])
    # the blocks served whole carry complete span trees
    full = [i for b in res.blocks if b.n_shed == 0
            for i in range(b.index * 256, b.index * 256 + b.n)]
    assert ttrace.validate_request_trees(drill["ttr"].to_chrome(),
                                         full)["n_requests"] == len(full)


def test_report_and_predicted_match_reference(prob, jprob):
    """The report and the P-K prediction of the same run: the report's
    array statistics bitwise, ``predicted`` (torch float64 in the port)
    at 1e-12 of the reference under ``enable_x64``."""
    t, j = traces(prob, jprob, [(4000, prob.server.lam)], 37)
    th = harness(prob, tserving.ReplayConfig(block_size=512))
    jh = jserving.ReplayHarness(jprob, jserving.ReplayConfig(block_size=512))
    tres, jres = th.run_virtual(t), jh.run_virtual(j)
    assert_same_result(tres, jres)
    rep = tres.report(prob)
    np.testing.assert_equal(dataclasses.asdict(rep),
                            dataclasses.asdict(jres.report(jprob)))
    np.testing.assert_equal(tres.measured(), jres.measured())
    np.testing.assert_equal(tres.goodput(60.0), jres.goodput(60.0))
    # the reference's contract
    assert rep.n == 4000 and rep.estimator_state is not None
    assert rep.mean_system_time == pytest.approx(tres.system_times.mean(),
                                                 rel=1e-12)
    pred = th.predicted(prob.server.lam)
    assert rep.mean_system_time == pytest.approx(pred["mean_system_time"],
                                                 rel=0.25)
    m = tres.measured()
    assert m["n"] == 3200 and m["ci95_system_time"] > 0
    with enable_x64():
        jpred = jh.predicted(prob.server.lam)
    for lengths in (None, LSTAR):
        tp = th.predicted(0.2, lengths)
        with enable_x64():
            jp = jh.predicted(0.2, lengths)
        assert tp["lengths"] == jp["lengths"]
        for k in ("accuracy", "mean_system_time", "mean_wait", "rho", "es",
                  "es2"):
            assert tp[k] == pytest.approx(jp[k], rel=1e-12, abs=1e-12), k
        for k, v in tp["wait_percentiles"].items():
            assert v == pytest.approx(jp["wait_percentiles"][k], rel=1e-12,
                                      abs=1e-12)
    assert pred["mean_wait"] == pytest.approx(jpred["mean_wait"], rel=1e-12)


# ================================================= the reference's contract
@pytest.mark.parametrize("rho", [0.6, 0.9])
def test_virtual_replay_pins_batched_des(prob, oracle_lengths, rho):
    """Fixed-policy virtual replay on common random numbers reproduces
    the batched Lindley pass (the same recursion on the same draws)."""
    t0 = np.asarray(prob.tasks.t0)
    c = np.asarray(prob.tasks.c)
    es = float(np.sum(np.asarray(prob.tasks.pi)
                      * (t0 + c * oracle_lengths)))
    batch = tqs.generate_streams(prob.tasks, rho / es, n_seeds=2,
                                 n_queries=4000, seed=29)
    s = t0[batch.types[0]] + c[batch.types[0]] * oracle_lengths[
        batch.types[0]]
    start, _ = lindley_numpy(batch.arrivals[0], s)
    res = harness(prob, tserving.ReplayConfig(block_size=333)).run_virtual(
        tqs.trace_from_stream_batch(batch, 0), fixed_lengths=oracle_lengths)
    np.testing.assert_allclose(res.waits, start - batch.arrivals[0],
                               rtol=0, atol=1e-8)


def test_block_carry_is_exact(prob, oracle_lengths):
    trace = tqs.generate_drift_trace(prob.tasks, [tqs.Segment(3000, 0.2)],
                                     seed=31)
    runs = [harness(prob, tserving.ReplayConfig(block_size=bs)).run_virtual(
        trace, fixed_lengths=oracle_lengths) for bs in (64, 997, 3000)]
    for r in runs[1:]:
        np.testing.assert_allclose(r.waits, runs[0].waits, rtol=0,
                                   atol=1e-9)


def test_controller_sees_zero_oracle_parameters(prob, oracle_lengths):
    """A controller built from a scrambled plant description is the same
    controller, and the loop still converges to the true oracle."""
    lying = tcore.Problem(
        tasks=tcore.TaskSet(names=prob.tasks.names, A=prob.tasks.A,
                            b=prob.tasks.b, D=prob.tasks.D,
                            t0=np.asarray(prob.tasks.t0) * 17.0,
                            c=np.asarray(prob.tasks.c)[::-1].copy(),
                            pi=np.eye(prob.tasks.n_tasks)[0]),
        server=tcore.ServerParams(123.0, prob.server.alpha,
                                  prob.server.l_max))
    cfg = tserving.ReplayConfig(block_size=512)
    honest = tserving.Controller.from_problem(prob, cfg, device="cpu")
    misled = tserving.Controller.from_problem(lying, cfg, device="cpu")
    np.testing.assert_array_equal(honest.A, misled.A)
    assert honest.alpha == misled.alpha and honest.l_max == misled.l_max
    trace = tqs.generate_drift_trace(
        prob.tasks, [tqs.Segment(15_000, prob.server.lam)], seed=7)
    h = harness(prob, cfg)
    h.controller = misled
    res = h.run_virtual(trace)
    assert np.max(np.abs(res.final_budgets - oracle_lengths)) <= 16


def test_drift_response(prob):
    """A lambda step: the estimators track it and the deployed budgets
    shrink under the heavier load."""
    lam0 = prob.server.lam
    trace = tqs.generate_drift_trace(
        prob.tasks, [tqs.Segment(6000, lam0), tqs.Segment(6000, 3 * lam0)],
        seed=13)
    cfg = tserving.ReplayConfig(block_size=256, est_halflife=512.0)
    res = harness(prob, cfg).run_virtual(trace)
    mid = [b for b in res.blocks if (b.index + 1) * cfg.block_size <= 6000]
    end = res.blocks[-1]
    assert mid[-1].estimator["lam"] == pytest.approx(lam0, rel=0.15)
    assert end.estimator["lam"] == pytest.approx(3 * lam0, rel=0.15)
    assert end.budgets.sum() < mid[-1].budgets.sum()


def test_empty_trace_raises(prob):
    h = harness(prob)
    empty = tqs.generate_drift_trace(prob.tasks, [tqs.Segment(1, 0.1)],
                                     seed=0)
    with pytest.raises(ValueError):
        h.run_virtual(empty.__class__(
            arrivals=np.zeros(0), types=np.zeros(0, dtype=np.int64),
            prompt_lens=np.zeros(0, dtype=np.int64),
            correct_us=np.zeros(0), segment_ids=np.zeros(0, dtype=np.int64),
            segments=(tqs.Segment(1, 0.1),), seed=0))
    with pytest.raises(ValueError, match="requires a DecodeEngine"):
        h.run_engine(empty)


def test_resolve_device_defaults_to_the_card(prob, monkeypatch):
    """No card, no fallback: the harness and the controller refuse the
    default device, and ``device="cpu"`` solves on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserving.ReplayHarness(prob)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserving.Controller.from_problem(prob, tserving.ReplayConfig())
    assert harness(prob).controller.device.type == "cpu"


def test_nan_corruption_does_not_corrupt_resolved_budgets(prob,
                                                          oracle_lengths):
    """NaN corruption on 5% of the observed services: the re-solved
    budgets stay finite, in bounds and near the clean run's."""
    trace = tqs.generate_drift_trace(
        prob.tasks, [tqs.Segment(12_000, prob.server.lam)], seed=7)
    cfg = tserving.ReplayConfig(block_size=512)
    clean = harness(prob, cfg).run_virtual(trace)
    dirty = harness(prob, cfg, faults=tfaults.ObservationCorruption(
        0.05, "nan", seed=2)).run_virtual(trace)
    assert dirty.estimator_state["n_skipped"] > 100
    assert np.isfinite(dirty.estimator_state["rho"])
    assert (dirty.budgets >= 0).all()
    assert (dirty.budgets <= prob.server.l_max).all()
    assert np.max(np.abs(dirty.final_budgets - clean.final_budgets)) <= 24
    assert np.max(np.abs(dirty.final_budgets - oracle_lengths)) <= 32


class _ExplodingServices(tfaults.FaultInjector):
    """Raises inside the block's fallible section after ``n_ok`` blocks."""

    def __init__(self, n_ok: int):
        self.n_ok, self.calls = int(n_ok), 0

    def service_multipliers(self, arrivals) -> np.ndarray:
        self.calls += 1
        if self.calls > self.n_ok:
            raise RuntimeError("engine died mid-block")
        return np.ones(np.asarray(arrivals).shape[0])


def test_engine_failure_leaves_harness_consistent(prob):
    """An exception mid-block leaves the controller bit-identical to a
    clean run over exactly the completed blocks."""
    n_ok, bs = 6, 256
    trace = tqs.generate_drift_trace(
        prob.tasks, [tqs.Segment(8 * bs, prob.server.lam)], seed=9)
    cfg = tserving.ReplayConfig(block_size=bs, resolve_every=2)
    crashing = harness(prob, cfg, faults=_ExplodingServices(n_ok))
    with pytest.raises(RuntimeError, match="mid-block"):
        crashing.run_virtual(trace)
    m = n_ok * bs
    sub = dataclasses.replace(
        trace, arrivals=trace.arrivals[:m], types=trace.types[:m],
        prompt_lens=trace.prompt_lens[:m], correct_us=trace.correct_us[:m],
        segment_ids=trace.segment_ids[:m])
    ref = harness(prob, cfg)
    ref.run_virtual(sub)
    assert crashing.controller.state().as_dict() == \
        ref.controller.state().as_dict()
    assert crashing.controller.n_resolves == ref.controller.n_resolves > 0
    np.testing.assert_array_equal(crashing.controller.budgets,
                                  ref.controller.budgets)


def test_admission_sheds_under_sustained_overload(prob, oracle_lengths):
    """At a sustained 2x the anchored service rate, with the re-solver
    frozen, the ladder reaches its top level and sheds only the
    configured classes, which cost nothing."""
    es = float(np.sum(np.asarray(prob.tasks.pi)
                      * (np.asarray(prob.tasks.t0)
                         + np.asarray(prob.tasks.c) * oracle_lengths)))
    trace = tqs.generate_drift_trace(prob.tasks,
                                     [tqs.Segment(8000, 2.0 / es)], seed=17)
    adm = tserving.AdmissionController(
        oracle_lengths, prob.server.l_max,
        tserving.AdmissionConfig(n_levels=3, rho_high=0.9, rho_low=0.7,
                                 dwell_down=1e9))
    res = harness(prob, tserving.ReplayConfig(block_size=256, l_init=16,
                                              warmup_blocks=10 ** 9),
                  admission=adm).run_virtual(trace)
    snap = res.admission
    assert snap["level"] == 3 and snap["n_shed"] > 0
    shed = ~res.served_mask()
    assert shed.sum() == snap["n_shed"]
    assert (res.services[shed] == 0).all()
    assert (res.budgets[shed] == 0).all()
    assert not res.correct[shed].any()
    assert set(np.unique(res.types[shed])) <= \
        set(np.flatnonzero(adm._shed_mask[3]))


def test_replay_discipline_threading(prob):
    """``tests/test_prediction.py``'s case: oracle SPJF is SJF block for
    block, noisy predictions reorder but stamp the FIFO budgets."""
    trace = tqs.generate_drift_trace(
        prob.tasks, [tqs.Segment(n_queries=600, lam=0.2)], seed=3)
    L = LSTAR.astype(np.int64)

    def run(**kw):
        return harness(prob, tserving.ReplayConfig(
            block_size=64, explore_frac=0.0, **kw)).run_virtual(
                trace, fixed_lengths=L)

    fifo, sjf, spjf = run(), run(discipline="sjf"), run(discipline="spjf")
    np.testing.assert_array_equal(spjf.waits, sjf.waits)
    assert sjf.waits.mean() < fifo.waits.mean()
    noisy = run(discipline="spjf", predictor=LengthPredictor(sigma=1.0))
    assert not np.array_equal(noisy.waits, sjf.waits)
    np.testing.assert_array_equal(noisy.budgets, fifo.budgets)
    np.testing.assert_allclose(noisy.services.sum(), fifo.services.sum())
    assert (noisy.waits > -1e-12).all()
    with pytest.raises(ValueError, match="unknown discipline"):
        harness(prob, tserving.ReplayConfig(discipline="lifo"))


def test_replay_single_block_matches_des(prob):
    """One block spanning the trace is the windowed DES engine exactly."""
    trace = tqs.generate_drift_trace(
        prob.tasks, [tqs.Segment(n_queries=400, lam=0.2)], seed=5)
    L = LSTAR.astype(np.int64)
    res = harness(prob, tserving.ReplayConfig(
        block_size=1000, discipline="sjf", explore_frac=0.0)).run_virtual(
            trace, fixed_lengths=L)
    t = prob.tasks
    svc = (np.asarray(t.t0) + np.asarray(t.c) * L)[trace.types]
    st, _, _ = windowed_start_finish(trace.arrivals[None], svc[None],
                                     svc[None])
    np.testing.assert_allclose(res.waits, st[0] - trace.arrivals, atol=1e-9)


# ============================================================ engine lane
@pytest.fixture(scope="module")
def small_model():
    """Reduced qwen3-0.6b (d_model 64) on the JAX package's parameters."""
    jcfg = j_reduced(j_get_config("qwen3-0.6b"), d_model=64)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("qwen3-0.6b"), d_model=64)
    params = from_jax_params(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("use_scan", [True, False])
def test_zero_token_request_matches_reference(small_model, use_scan):
    """A request with budget 0 and no answer tokens (the paper's solution
    gives three tasks 0) is its prefill alone, as in the JAX engine; in a
    batch beside a longer row it emits nothing."""
    jcfg, jparams, cfg, params = small_model
    prompts = (np.arange(16) % 97 + 1).astype(np.int32).reshape(2, 8)
    teng = tserving.DecodeEngine(cfg, params, cache_capacity=64, chunk=8)
    jeng = jserving.DecodeEngine(jcfg, jparams, cache_capacity=64, chunk=8)
    for budgets in ([0, 0], [0, 5]):
        got = teng.generate(prompts, budgets, max_extra_tokens=0,
                            use_scan=use_scan)
        want = jeng.generate(prompts, budgets, max_extra_tokens=0,
                             use_scan=use_scan)
        for k in ("tokens", "n_generated", "n_reasoning"):
            np.testing.assert_array_equal(got[k], want[k], strict=True)
        assert got["tokens"].shape == (2, max(budgets))


def test_engine_lane_real_decodes(prob, small_model):
    """Reduced qwen3-0.6b decodes drive the twin: budgets enforced per
    decode, one capture of the decode step across every budget, waits
    obeying Lindley on the measured services, and a positive latency
    curve calibrated from them."""
    cfg, params = small_model[2:]
    eng = tserving.DecodeEngine(cfg, params, cache_capacity=64, chunk=8)
    small = tcore.Problem(tasks=prob.tasks, server=tcore.ServerParams(
        prob.server.lam, 2.0, 24.0))
    rcfg = tserving.ReplayConfig(block_size=8, l_init=8, min_services=4,
                                 explore_frac=0.5, explore_min_spread=4,
                                 est_halflife=16.0)
    trace = tqs.generate_drift_trace(prob.tasks, [tqs.Segment(24, 5.0)],
                                     seed=41, prompt_len_range=(8, 8))
    graph_hooks.reset()
    res = harness(small, rcfg, engine=eng).run_engine(
        trace, prompt_len=8, max_extra_tokens=0)
    assert graph_hooks.capture_counts().get("engine.chunk", 0) == 1
    assert res.mode == "engine" and res.n == 24
    assert (res.services > 0).all()
    assert (res.budgets <= 24).all() and len(set(res.budgets)) > 1
    assert res.n_resolves >= 1
    est = res.estimator_state
    assert est["es"] > 0 and est["n_services"] == 24
    assert np.all(np.asarray(est["t0"]) > 0)
    start = res.arrivals + res.waits
    finish = start + res.services
    assert np.all(start[1:] >= np.maximum(res.arrivals[1:], finish[:-1])
                  - 1e-9)
