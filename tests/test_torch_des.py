"""The port's discrete-event simulator against ``repro.queueing_sim``.

Same NumPy inputs into both packages. Bitwise: the workload streams,
batches and drift traces, the heapq oracles, the predictor's draws, and
each plain torch lane (``backend="torch"`` on ``device="cpu"``, the CUDA
kernels' plain versions) against its JAX lane: ``lindley_jax``,
``free_server_jax`` with mixed per-stream server counts, ``windowed_jax``
for the four keyed disciplines (SJF's ties are the rule: one service time
a task type) at windows 8 (overflowing, so the heapq fallback runs) and
32, and ``impatience_jax`` in both orphaned modes. The layers above
(``simulate_fifo_batch``, ``sweep``, ``sweep_disciplines``, ``sweep_mgc``,
``summarize_impatience``, ``simulate_batch_service``) at rtol 1e-12, the
reference tests' pin (they hold the numpy and JAX lanes to 1e-9 of the
heapq loop). The JAX package runs under ``enable_x64``: outside it its
jnp budget clip and P-K helpers round to f32.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import queueing_sim as J
from repro.compat import enable_x64
from repro.data import predictor as jpred
from repro.obs import metrics as jmetrics
from repro_torch import core as tcore
from repro_torch import queueing_sim as T
from repro_torch.data import predictor as tpred
from repro_torch.kernels import des_scan
from repro_torch.obs import metrics as tmetrics

LSTAR = np.array([0.0, 340.0, 0.0, 0.0, 345.0, 30.0])
POLICIES = {"optimal": LSTAR, "uniform_100": np.full(6, 100.0),
            "uniform_300": np.full(6, 300.0)}
F12 = dict(rtol=1e-12, atol=1e-12)
KEYED = ("fifo", "sjf", "priority", "spjf")


@pytest.fixture(scope="module")
def probs():
    return jcore.paper_problem(), tcore.paper_problem()


def _batch(prob, lam, n_seeds=4, n=300, seed=3):
    return J.generate_streams(prob, lam, n_seeds, n, seed=seed)


def _svc(lengths, types):
    p = jcore.paper_problem()
    return (np.asarray(p.tasks.t0) + np.asarray(p.tasks.c) * lengths)[types]


def _rows(stream):
    return [dataclasses.astuple(q) for q in stream.queries]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _fields_close(a, b, fields, **tol):
    for f in fields:
        np.testing.assert_allclose(np.asarray(getattr(b, f), dtype=float),
                                   np.asarray(getattr(a, f), dtype=float),
                                   err_msg=f, **tol)


# ------------------------------------------------------------- workloads
@pytest.mark.parametrize("lam,n_seeds,n,seed", [(0.1, 4, 200, 0),
                                                (0.7, 3, 57, 9),
                                                (0.2, 2, 0, 1)])
def test_streams_and_batches_bitwise(probs, lam, n_seeds, n, seed):
    jp, tp = probs
    a = J.generate_streams(jp.tasks, lam, n_seeds, n, seed=seed)
    b = T.generate_streams(tp.tasks, lam, n_seeds, n, seed=seed)
    for f in ("arrivals", "types", "prompt_lens", "correct_us", "horizon"):
        _eq(getattr(a, f), getattr(b, f))
    assert (b.lam, b.seed, b.n_seeds, b.n_queries) == (
        a.lam, a.seed, a.n_seeds, a.n_queries)
    if n:
        assert _rows(b.stream(1)) == _rows(a.stream(1))
        tr_a = J.trace_from_stream_batch(a, 0)
        tr_b = T.trace_from_stream_batch(b, 0)
        for f in ("arrivals", "types", "prompt_lens", "correct_us",
                  "segment_ids"):
            _eq(getattr(tr_a, f), getattr(tr_b, f))
        s_a, s_b = a.stream(0), b.stream(0)
        _eq(J.empirical_mixture(s_a, 6), T.empirical_mixture(s_b, 6))


def test_drift_trace_bitwise(probs):
    jp, tp = probs
    pi = (0.5, 0.1, 0.1, 0.1, 0.1, 0.1)
    segs = [dict(n_queries=120, lam=0.1), dict(n_queries=80, lam=0.3, pi=pi),
            dict(n_queries=50, lam=0.05)]
    a = J.generate_drift_trace(jp.tasks, [J.Segment(**s) for s in segs],
                               seed=4)
    b = T.generate_drift_trace(tp.tasks, [T.Segment(**s) for s in segs],
                               seed=4)
    for f in ("arrivals", "types", "prompt_lens", "correct_us",
              "segment_ids"):
        _eq(getattr(a, f), getattr(b, f))
    assert b.horizon == a.horizon and len(b) == len(a)
    assert _rows(b.to_stream()) == _rows(a.to_stream())
    with pytest.raises(ValueError, match="pi override"):
        T.generate_drift_trace(tp.tasks, [T.Segment(10, 0.1, pi=(1.0,))])


# ------------------------------------------------------- heapq oracles
@pytest.mark.parametrize("discipline", ["fifo", "sjf", "priority", "srpt",
                                        "spjf", "sprpt"])
def test_heapq_oracles_and_simulate_bitwise(probs, discipline):
    jp, tp = probs
    a = J.generate_stream(jp.tasks, 0.45, 250, seed=5)
    b = T.generate_stream(tp.tasks, 0.45, 250, seed=5)
    svc = _svc(LSTAR, np.array([q.task for q in a.queries]))
    pred = None
    if discipline in ("spjf", "sprpt"):
        pred = jpred.LengthPredictor(sigma=0.6, seed=2).predict(svc)
    with enable_x64():
        ra = J.simulate(jp, LSTAR, a, discipline, predicted=pred)
    rb = T.simulate(tp, LSTAR, b, discipline, predicted=pred)
    for f in ("mean_wait", "mean_system_time", "mean_service",
              "utilization", "accuracy", "mean_accuracy_prob", "objective",
              "per_task_system_time", "per_task_count", "n"):
        _eq(getattr(ra, f), getattr(rb, f))


@pytest.mark.parametrize("c", [1, 2, 3])
def test_event_loop_mgc_bitwise(c):
    rng = np.random.default_rng(c)
    arr = np.cumsum(rng.exponential(0.4, 300))
    svc = rng.choice([0.3, 0.9, 1.7], 300)
    for keys in (arr, svc):
        _eq(np.stack(J.event_loop_mgc(arr, svc, keys, c)),
            np.stack(T.event_loop_mgc(arr, svc, keys, c)))
    _eq(J.srpt_event_loop(arr, svc), T.srpt_event_loop(arr, svc))
    pred = svc * rng.lognormal(0, 0.5, 300)
    _eq(J.sprpt_event_loop(arr, svc, pred), T.sprpt_event_loop(arr, svc,
                                                                  pred))


@pytest.mark.parametrize("orphaned", [True, False])
def test_impatience_oracle_bitwise(orphaned):
    rng = np.random.default_rng(11)
    a = np.cumsum(rng.exponential(1 / 0.95, 300))
    s = rng.exponential(1.0, 300)
    kw = dict(patience=2.0, max_retries=3, backoff0=0.5,
              orphaned_service=orphaned)
    ra = J.impatience_event_loop(a, s, J.RetryPolicy(**kw), 2)
    rb = T.impatience_event_loop(a, s, T.RetryPolicy(**kw), 2)
    for f in ("served", "start", "finish", "wait", "n_attempts"):
        np.testing.assert_array_equal(getattr(rb, f), getattr(ra, f))


def test_predictions_and_analytics(probs):
    jp, tp = probs
    with enable_x64():
        pa = J.pk_prediction(jp, LSTAR)
    assert T.pk_prediction(tp, LSTAR) == pytest.approx(pa, rel=1e-12)
    for c in (1, 2, 4):
        assert T.mgc_prediction(tp, LSTAR, c) == J.mgc_prediction(jp, LSTAR,
                                                                  c)
    x = np.random.default_rng(0).normal(size=(3, 7))
    _eq(J.ci95(x), T.ci95(x))
    _eq(J.ci95(x[:, :1]), T.ci95(x[:, :1]))


# ----------------------------------------------- plain lanes vs JAX lanes
@pytest.mark.parametrize("lam,n_seeds,n", [(0.15, 4, 300), (0.5, 3, 128)])
def test_lindley_plain_lane_bitwise(probs, lam, n_seeds, n):
    b = _batch(probs[0].tasks, lam, n_seeds, n)
    svc = np.stack([_svc(LSTAR, b.types), _svc(np.full(6, 300.0), b.types)])
    want = J.lindley_jax(b.arrivals, svc)
    got = T.lindley_torch(b.arrivals, svc, device="cpu")
    for w, g in zip(want, got):
        _eq(w, g)


def test_free_server_plain_lane_bitwise(probs):
    b = _batch(probs[0].tasks, 0.6, 6, 300)
    svc = _svc(LSTAR, b.types)
    c = np.array([1, 2, 3, 4, 8, 2])        # absent servers at +inf
    want = J.free_server_jax(b.arrivals, svc, c)
    got = T.free_server_torch(b.arrivals, svc, c, device="cpu")
    for w, g in zip(want, got):
        _eq(w, g)
    ref = J.event_loop_mgc(b.arrivals[2], svc[2], b.arrivals[2], 3)
    _eq(got[0][2], ref[0])


def _keys(discipline, arrivals, svc, lengths, types, sigma=0.5):
    acc = J.mg1.accuracy_np(jcore.paper_problem().tasks, lengths)[types]
    pred = (jpred.LengthPredictor(sigma=sigma, seed=1).predict(svc)
            if discipline == "spjf" else None)
    return J.discipline_keys(discipline, arrivals=arrivals, services=svc,
                             accuracy=acc, predicted=pred)


@pytest.mark.parametrize("window", [8, 32])
@pytest.mark.parametrize("discipline", KEYED)
def test_windowed_plain_lane_bitwise(probs, discipline, window):
    b = _batch(probs[0].tasks, 0.55, 4, 300)
    svc = _svc(LSTAR, b.types)
    keys = _keys(discipline, b.arrivals, svc, LSTAR, b.types)
    if discipline == "sjf":
        assert len(np.unique(keys[0])) <= 6   # ties are the rule
    with enable_x64():
        want = J.windowed_jax(b.arrivals, svc, keys, window)
    got = T.windowed_torch(b.arrivals, svc, keys, window, device="cpu")
    for w, g in zip(want, got):
        _eq(w, g)
    if window == 8 and discipline != "fifo":
        assert got[2].any()                   # the fallback runs
    st, fin, ovf = T.windowed_start_finish(b.arrivals, svc, keys, window,
                                           backend="torch", device="cpu")
    for i in range(b.n_seeds):
        ref = J.event_loop(b.arrivals[i], svc[i], keys[i])
        np.testing.assert_allclose(st[i], ref[0], rtol=0, atol=1e-10)
        np.testing.assert_allclose(fin[i], ref[1], rtol=0, atol=1e-10)


@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("orphaned", [True, False])
def test_impatience_plain_lane_bitwise(orphaned, c):
    rng = np.random.default_rng(11)
    a = np.cumsum(rng.exponential(1 / (0.95 * c), size=(3, 200)), axis=1)
    s = rng.exponential(1.0, size=(3, 200))
    kw = dict(patience=2.0, max_retries=3, backoff0=0.5,
              orphaned_service=orphaned)
    with enable_x64():
        want = J.impatience_jax(a, s, J.RetryPolicy(**kw), c)
    got = T.impatience_torch(a, s, T.RetryPolicy(**kw), c, device="cpu")
    for f in ("served", "start", "finish", "wait", "n_attempts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert np.isnan(got.start[~got.served]).all() and (~got.served).any()
    ref = T.impatience_numpy(a, s, T.RetryPolicy(**kw), c)
    np.testing.assert_allclose(got.finish, ref.finish, rtol=0, atol=1e-9)
    sa = J.summarize_impatience(want, a, s, J.RetryPolicy(**kw), c_servers=c)
    sb = T.summarize_impatience(got, a, s, T.RetryPolicy(**kw), c_servers=c)
    assert sb == pytest.approx(sa, rel=1e-12)


def test_impatience_plain_pass_per_stream_policies():
    """Streams of four retry policies stacked into one plain pass (per-stream
    patience and orphaned mode) give each policy's own pass bitwise."""
    from repro_torch.queueing_sim import impatience

    rng = np.random.default_rng(12)
    a = np.cumsum(rng.exponential(1 / 0.95, size=(2, 150)), axis=1)
    s = torch.from_numpy(rng.exponential(1.0, size=(2, 150)))
    pols = [T.RetryPolicy(patience=tau, max_retries=3, backoff0=0.5,
                          orphaned_service=orph)
            for tau in (2.0, 200.0) for orph in (True, False)]
    ev = [[torch.from_numpy(x) for x in impatience._sorted_events(a, p)]
          for p in pols]
    want = [des_scan.impatience_pass_plain(*e, s, p.patience, p.max_retries,
                                           1, p.orphaned_service)
            for e, p in zip(ev, pols)]
    per = lambda f: torch.tensor([f(p) for p in pols]).repeat_interleave(2)
    got = des_scan.impatience_pass_plain(
        *(torch.cat([e[j] for e in ev]) for j in range(3)),
        s.repeat(len(pols), 1), per(lambda p: p.patience), 3, 1,
        per(lambda p: p.orphaned_service))
    for k, w in enumerate(want):
        for g, x in zip(got, w):
            torch.testing.assert_close(g[2 * k:2 * k + 2], x, rtol=0, atol=0,
                                       equal_nan=True)


# ------------------------------------------------------- sim layers
def test_simulate_fifo_batch_and_metrics(probs):
    jp, tp = probs
    b = _batch(jp.tasks, 0.15, 4, 300)
    L = np.stack(list(POLICIES.values()))
    jm, tm = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    want = J.simulate_fifo_batch(jp, L, b, metrics=jm)
    got = T.simulate_fifo_batch(tp, L, b, metrics=tm)
    _fields_close(want, got, ("mean_wait", "mean_system_time",
                              "mean_service", "utilization", "accuracy",
                              "mean_accuracy_prob", "objective"), **F12)
    assert tm.as_dict() == jm.as_dict()
    got_t = T.simulate_fifo_batch(tp, L[0], b, backend="torch", device="cpu")
    want_j = J.simulate_fifo_batch(jp, L[0], b, backend="jax")
    _fields_close(want_j, got_t, ("mean_wait", "mean_system_time"), **F12)
    s = T.simulate_fifo(tp, LSTAR, b.stream(0), backend="torch",
                        device="cpu")
    r = J.simulate_fifo(jp, LSTAR, b.stream(0))
    assert s.mean_system_time == pytest.approx(r.mean_system_time,
                                               rel=1e-12)


@pytest.mark.parametrize("discipline", ["fifo", "sjf"])
def test_sweep_matches_reference(probs, discipline):
    jp, tp = probs
    lams = [0.1, 0.2, 0.45]
    kw = dict(n_seeds=3, n_queries=250, seed=2, discipline=discipline,
              window=16)
    with enable_x64():
        want = J.sweep(jp, POLICIES, lams, **kw)
    got = T.sweep(tp, POLICIES, lams, **kw)
    got_t = T.sweep(tp, POLICIES, lams, backend="torch", device="cpu", **kw)
    fields = ("lengths", "rho_analytic", "mean_wait", "mean_system_time",
              "utilization", "accuracy", "objective", "ci_system_time",
              "stable", "overflow_frac")
    _fields_close(want, got, fields, **F12)
    _fields_close(want, got_t, ("mean_wait", "mean_system_time"), **F12)


def test_sweep_disciplines_all_six(probs):
    jp, tp = probs
    lams = [0.12, 0.3]
    pred_j = jpred.LengthPredictor(sigma=0.7, seed=3)
    pred_t = tpred.LengthPredictor(sigma=0.7, seed=3)
    kw = dict(disciplines=T.ALL_DISCIPLINES, n_seeds=3, n_queries=300,
              seed=1, window=16)
    with enable_x64():
        want = J.sweep_disciplines(jp, POLICIES, lams, predictor=pred_j,
                                   **kw)
    got = T.sweep_disciplines(tp, POLICIES, lams, predictor=pred_t, **kw)
    got_t = T.sweep_disciplines(tp, POLICIES, lams, predictor=pred_t,
                                backend="torch", device="cpu", **kw)
    assert set(got) == set(want) == set(J.ALL_DISCIPLINES)
    assert any(want[d].overflow_frac.any() for d in want)
    fields = ("mean_wait", "mean_system_time", "utilization", "objective",
              "ci_system_time", "overflow_frac")
    for d in want:
        _fields_close(want[d], got[d], fields, **F12)
        _fields_close(want[d], got_t[d], ("mean_wait", "mean_system_time"),
                      **F12)


def test_simulate_batch_and_discipline(probs):
    jp, tp = probs
    b = _batch(jp.tasks, 0.45, 3, 250)
    L = np.stack(list(POLICIES.values()))
    fields = ("mean_wait", "mean_system_time", "utilization", "objective")
    for d in ("priority", "spjf", "srpt", "sprpt"):
        want = J.simulate_batch(jp, L, b, d, window=16,
                                predictor=jpred.LengthPredictor(sigma=0.4))
        got = T.simulate_batch(tp, L, b, d, window=16,
                               predictor=tpred.LengthPredictor(sigma=0.4))
        _fields_close(want, got, fields, **F12)
    want = J.simulate_discipline(jp, LSTAR, b.stream(1), "sjf", window=8)
    got = T.simulate_discipline(tp, LSTAR, b.stream(1), "sjf",
                                backend="torch", window=8, device="cpu")
    assert got.mean_system_time == pytest.approx(want.mean_system_time,
                                                 rel=1e-12)
    _eq(got.per_task_count, want.per_task_count)


def test_multiserver_layers(probs):
    jp, tp = probs
    lams = [0.3, 0.9]
    kw = dict(n_seeds=3, n_queries=250, seed=4)
    with enable_x64():
        want = J.sweep_mgc(jp, POLICIES, lams, 2, **kw)
    got = T.sweep_mgc(tp, POLICIES, lams, 2, backend="torch", device="cpu",
                      **kw)
    _fields_close(want, got, ("lengths", "rho_analytic", "mean_wait",
                              "mean_system_time", "utilization", "stable"),
                  **F12)
    assert got.c_servers == 2
    b = _batch(jp.tasks, 0.5, 3, 200)
    c = np.array([1, 2, 4])
    L = np.stack(list(POLICIES.values()))
    want = J.simulate_mgc_batch(jp, L, b, c)
    got = T.simulate_mgc_batch(tp, L, b, c)
    _fields_close(want, got, ("mean_wait", "utilization"), **F12)
    want = J.simulate_mgc(jp, LSTAR, b.stream(0), 3, "sjf")
    got = T.simulate_mgc(tp, LSTAR, b.stream(0), 3, "sjf")
    assert got.mean_wait == want.mean_wait
    assert got.utilization == want.utilization


def test_batch_service_sim(probs):
    jp, tp = probs
    jm = jcore.StepLatencyModel(d0=0.02, d1=0.004)
    tm = tcore.StepLatencyModel(d0=0.02, d1=0.004)
    for max_batch in (1, 4):
        want = J.simulate_batch_service(jp.tasks, LSTAR, 0.4, jm, max_batch,
                                        n=300, seed=2)
        got = T.simulate_batch_service(tp.tasks, LSTAR, 0.4, tm, max_batch,
                                       n=300, seed=2)
        for f in want._fields:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


# ------------------------------------------------------------ predictor
def test_length_predictor_bitwise():
    s = np.random.default_rng(0).exponential(3.0, (4, 50))
    for kw in (dict(), dict(sigma=0.8, seed=5)):
        a, b = jpred.LengthPredictor(**kw), tpred.LengthPredictor(**kw)
        _eq(a.predict(s), b.predict(s))
        rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
        _eq(a.predict(s, rng=rng_a), b.predict(s, rng=rng_b))
    for fit in ("fit_two_point", "fit_quantile"):
        a = getattr(jpred, fit)(s, sigma=0.3, seed=2)
        b = getattr(tpred, fit)(s, sigma=0.3, seed=2)
        assert vars(a) == vars(b)
        _eq(a.predict(s), b.predict(s))
    a = jpred.calibrate_from_synthetic(jcore.paper_problem(), LSTAR,
                                       n_batches=2, batch_size=32)
    b = tpred.calibrate_from_synthetic(tcore.paper_problem(), LSTAR,
                                       n_batches=2, batch_size=32)
    assert vars(a) == vars(b)
    _eq(jpred.lognormal_factors(s, 0.4), tpred.lognormal_factors(s, 0.4))


# --------------------------------------------------- device contract
def test_lane_wrappers_never_fall_back():
    """A tensor that is not on the CPU goes to the launch path, which
    checks its operands and raises: it never takes the plain version."""
    meta = torch.zeros(2, 5, dtype=torch.float64, device="meta")
    cases = [lambda: des_scan.lindley(meta, meta),
             lambda: des_scan.free_server(meta, meta, meta[:, :2]),
             lambda: des_scan.windowed(meta, meta, meta, 2),
             lambda: des_scan.impatience_pass(meta, meta.long(), meta.long(),
                                              meta, 1.0, 1, 1, True)]
    for call in cases:
        with pytest.raises(ValueError, match="expected CUDA tensors"):
            call()


def test_torch_backend_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.cumsum(np.ones((2, 4)), axis=1)
    for call in (lambda: T.lindley_torch(a, a),
                 lambda: T.free_server_torch(a, a, 2),
                 lambda: T.windowed_torch(a, a, a, 4),
                 lambda: T.impatience_torch(a, a, T.RetryPolicy())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="unknown backend"):
        T.simulate_fifo_batch(tcore.paper_problem(), LSTAR,
                              T.generate_streams(tcore.paper_problem().tasks,
                                                 0.1, 1, 3),
                              backend="jax")
