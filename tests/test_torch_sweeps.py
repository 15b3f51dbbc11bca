"""``repro_torch.sweeps`` against ``repro.sweeps`` on small grids.

The grids run here with ``device="cpu"``, the JAX package's under
``enable_x64``. Contract (``tests/test_solver_grid.py``'s): continuous
optima within 1e-6; integer budgets, ``feasible``, ``stable``,
``used_pga`` and both per-cell iteration counts identical (the JAX
package's ``vmap`` counts per lane); the other float fields within rtol
1e-9 (the residuals, differences of nearly equal numbers, within 1e-10
absolute). One 12-cell M/G/1 grid holds fixed-point cells, PGA-fallback
cells (lambda 1-3 and heavy alpha), an infeasible cell and calibration
perturbations; one 6-cell grid holds c in {1, 2, 4} (the M/G/c PGA path)
with an infeasible cell. Then ``reference_check``, the frontier layer,
the batch-service joint solve, ``evaluate_cells`` on identical NumPy
streams (the NumPy backend bitwise against the JAX package's NumPy
backend, the torch backend bitwise against its JAX backend), the
prediction-error frontier and the tokenizer.
"""
import dataclasses

import numpy as np
import pytest

import repro.data as jdata
import repro.sweeps as jsweeps
import repro_torch.data as tdata
import repro_torch.sweeps as tsweeps
from repro import core as jcore
from repro.compat import enable_x64
from repro_torch import core as tcore
from repro_torch.compat import cap_xdist_threads

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

# (lam, alpha, l_max, calibration scale of c, of A) per cell
CELLS = [(0.05, 30.0, 32768.0, 1.0, 1.0), (0.2, 30.0, 1024.0, 1.0, 1.0),
         (0.4, 60.0, 32768.0, 1.0, 1.0), (1.0, 30.0, 32768.0, 1.0, 1.0),
         (2.0, 30.0, 32768.0, 1.0, 1.0), (3.0, 30.0, 32768.0, 1.0, 1.0),
         (0.3, 10.0, 1024.0, 1.0, 1.0), (0.1, 30.0, 32768.0, 0.8, 1.0),
         (0.1, 30.0, 32768.0, 1.2, 0.9), (0.45, 45.0, 1024.0, 1.0, 1.0),
         (50.0, 30.0, 1024.0, 1.0, 1.0), (0.25, 20.0, 32768.0, 1.0, 1.1)]
UNPERTURBED = [i for i, c in enumerate(CELLS) if c[3:] == (1.0, 1.0)
               and c[0] < 5.0]
# (lam, c): M/G/c cells at alpha 30, l_max 32768, the last infeasible
MGC_CELLS = [(0.1, 1), (0.2, 2), (0.6, 2), (0.3, 1), (1.0, 4), (50.0, 2)]

FIELDS = [f.name for f in dataclasses.fields(tsweeps.GridSolution)]
EXACT = ("lengths_int", "feasible", "stable", "used_pga", "fp_iterations",
         "pga_iterations", "fp_converged", "lam", "alpha", "l_max", "c")
RESIDUALS = ("fp_residual", "kkt_residual")


@pytest.fixture(scope="module")
def tasks():
    return jcore.paper_problem().tasks, tcore.paper_problem().tasks


def _grid_args(grid: str):
    if grid == "mg1":
        lam, alpha, l_max, sc, sa = (np.array(x) for x in zip(*CELLS))
        return (lam, alpha, l_max), dict(calib={"c": sc, "A": sa})
    lam, c = (np.array(x) for x in zip(*MGC_CELLS))
    return (lam, 30.0, 32768.0), dict(c=c)


@pytest.fixture(scope="module")
def grids(tasks):
    out = {}
    for grid in ("mg1", "mgc"):
        args, kw = _grid_args(grid)
        with enable_x64():
            want = jsweeps.solve_grid(tasks[0], *args, **kw)
        out[grid] = (want, tsweeps.solve_grid(tasks[1], *args, device="cpu",
                                              **kw))
    return out


def test_sweeps_and_data_exports():
    assert tsweeps.__all__ == jsweeps.__all__
    for name in ("ByteTokenizer", "PAD_ID", "BOS_ID", "EOS_ID"):
        assert name in tdata.__all__
        assert getattr(tdata, name) == getattr(jdata, name) or \
            name == "ByteTokenizer"


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("grid", ["mg1", "mgc"])
def test_grid_field_matches_reference(grids, grid, field):
    want, got = (np.asarray(getattr(s, field)) for s in grids[grid])
    assert got.shape == want.shape
    if field in EXACT:
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    if field == "lengths_cont":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    elif field in RESIDUALS:
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9,
                                   atol=1e-10)
    else:
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9,
                                   atol=1e-12)
    np.testing.assert_array_equal(got[~fin], want[~fin])


def test_grid_covers_its_paths(grids):
    """The 12-cell grid exercises what it claims to."""
    sol = grids["mg1"][1]
    assert sol.used_pga.sum() >= 4 and sol.fp_converged.sum() >= 6
    assert not sol.feasible[10] and not sol.stable[10]
    assert sol.pga_iterations[~sol.used_pga].max() == 0
    assert sol.fp_iterations.max() == 500
    mgc = grids["mgc"][1]
    assert np.all(mgc.used_pga == mgc.feasible) and not mgc.feasible[-1]
    assert np.all(np.isinf(mgc.contraction_Linf[mgc.c > 1]))


def test_reference_check_against_scalar_solve(tasks, grids):
    """The port's grid against the port's scalar ``solve``, cell by cell
    (a fixed-point cell and a PGA-fallback cell)."""
    sol = grids["mg1"][1]
    assert sol.used_pga[3] and not sol.used_pga[0]
    worst = tsweeps.reference_check(tasks[1], sol, cells=[0, 3])
    assert worst < 1e-6
    assert {0, 3} <= set(UNPERTURBED)
    with pytest.raises(ValueError, match="c=1"):
        tsweeps.reference_check(tasks[1], grids["mgc"][1])


def test_grid_shape_broadcast_and_cell(tasks):
    """Broadcasting a (lam x alpha) mesh, ``ravel`` and ``cell``."""
    lam = np.array([0.1, 0.2])[:, None]
    alpha = np.array([10.0, 30.0, 60.0])[None, :]
    sol = tsweeps.solve_grid(tasks[1], lam, alpha, 1024.0, device="cpu")
    assert sol.shape == (2, 3) and sol.n_cells == 6
    assert sol.lengths_cont.shape == (2, 3, 6)
    flat = sol.ravel()
    assert flat.lengths_int.shape == (6, 6)
    cell = sol.cell((1, 2))
    assert cell["lam"] == 0.2 and cell["alpha"] == 60.0
    np.testing.assert_array_equal(cell["lengths_int"], flat.lengths_int[5])
    with pytest.raises(ValueError, match="calib"):
        tsweeps.solve_grid(tasks[1], 0.1, 30.0, 1024.0,
                           calib={"zeta": np.ones(1)}, device="cpu")
    with pytest.raises(ValueError, match="server counts"):
        tsweeps.solve_grid(tasks[1], 0.1, 30.0, 1024.0, c=1.5, device="cpu")


@pytest.mark.parametrize("use", ["int", "cont"])
@pytest.mark.parametrize("grid", ["mg1", "mgc"])
def test_pareto_front_matches_reference(grids, grid, use):
    want, got = (f(s, use=use) for f, s in
                 zip((jsweeps.pareto_front, tsweeps.pareto_front),
                     grids[grid]))
    np.testing.assert_array_equal(got["indices"], want["indices"])
    for k in ("accuracy", "system_time", "lam", "alpha", "lengths"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-6)


def test_pareto_mask_and_saturation(tasks):
    rng = np.random.default_rng(2)
    acc, t = rng.uniform(size=40), rng.uniform(size=40)
    acc[3], t[7] = np.inf, np.nan
    np.testing.assert_array_equal(tsweeps.pareto_mask(acc, t),
                                  jsweeps.pareto_mask(acc, t))
    assert tsweeps.saturation_rate(tasks[1]) == \
        jsweeps.saturation_rate(tasks[0])
    rho = np.array([0.5, 0.9, 1.0, 1.3])
    np.testing.assert_array_equal(
        tsweeps.heavy_traffic_lams(tasks[1], rho),
        jsweeps.heavy_traffic_lams(tasks[0], rho))


def test_max_sustainable_lambda_matches_reference(tasks):
    """Twelve rates and one refinement: the JAX package reuses its
    compiled 12-cell solver."""
    kw = dict(min_accuracy=0.30, n_grid=12, refine=1)
    with enable_x64():
        want = jsweeps.max_sustainable_lambda(tasks[0], 30.0, 32768.0, **kw)
    got = tsweeps.max_sustainable_lambda(tasks[1], 30.0, 32768.0,
                                         device="cpu", **kw)
    assert got["lam"] == pytest.approx(want["lam"], rel=1e-12)
    for k in ("accuracy", "system_time"):
        assert got[k] == pytest.approx(want[k], rel=1e-9)
    np.testing.assert_array_equal(got["lengths"], want["lengths"])


def test_frontier_comparison_matches_reference():
    rng = np.random.default_rng(5)
    ma, mt, pa, pt, ci = (rng.uniform(0.1, 1.0, 6) for _ in range(5))
    kw = dict(ci_system_time=ci, measured_percentiles={"p50": 1.0,
                                                       "p99": 3.0},
              predicted_percentiles={"p50": 0.9, "p99": 3.3},
              drift={"ok": True})
    want = jsweeps.frontier_comparison(ma, mt, pa, pt, **kw)
    got = tsweeps.frontier_comparison(ma, mt, pa, pt, **kw)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v)
        else:
            assert got[k] == v, k


def test_batch_service_grid_matches_reference(tasks):
    """The occupancy joint solve (max_batch 4; three damped rounds, short
    of its six to convergence) and its flat model, which is one plain
    c = max_batch grid."""
    from repro.core.batch_service import StepLatencyModel as JModel
    from repro_torch.core.batch_service import StepLatencyModel as TModel

    for d1 in (0.004, 0.0):
        args = (0.6, 30.0, 1024.0)
        with enable_x64():
            want = jsweeps.solve_grid_batch_service(
                tasks[0], *args, JModel(0.02, d1), max_batch=4,
                max_rounds=3)
        got = tsweeps.solve_grid_batch_service(
            tasks[1], *args, TModel(0.02, d1), max_batch=4, max_rounds=3,
            device="cpu")
        assert isinstance(got, tsweeps.BatchServiceGrid)
        assert (got.rounds, got.converged) == (want.rounds, want.converged)
        np.testing.assert_allclose(got.ratio, want.ratio, rtol=1e-12)
        np.testing.assert_allclose(got.b_bar, want.b_bar, rtol=1e-12)
        np.testing.assert_array_equal(got.solution.lengths_int,
                                      want.solution.lengths_int)
        np.testing.assert_allclose(got.solution.lengths_cont,
                                   want.solution.lengths_cont, atol=1e-6)
        assert (got.rounds, got.converged) == ((1, True) if d1 == 0.0
                                               else (3, False))


EVAL_LENGTHS = np.array([[0, 340, 0, 0, 345, 30.0], [0, 200, 0, 0, 200, 30.0],
                         [100.0] * 6])
EVAL_CASES = {"fifo": dict(discipline="fifo"),
              "mgc": dict(discipline="fifo", c=np.array([1, 2, 2])),
              "sjf": dict(discipline="sjf", window=8),
              "priority": dict(discipline="priority"),
              "srpt": dict(discipline="srpt", window=8),
              "warmup": dict(discipline="fifo", warmup_frac=0.2)}


def _eval_equal(got, want):
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_evaluate_cells_matches_reference(tasks, case):
    """Identical NumPy streams: the NumPy backend bitwise equal to the JAX
    package's, the torch backend (the lanes' plain versions here) bitwise
    equal to its ``backend="jax"`` (the JAX DES lanes) and within 1e-12
    of the NumPy backend (whose Lindley pass is the cumsum form)."""
    lam = np.array([0.1, 0.3, 0.5])
    kw = dict(n_seeds=3, n_queries=400, seed=4, **EVAL_CASES[case])
    want = jsweeps.evaluate_cells(tasks[0], lam, EVAL_LENGTHS, **kw)
    got = tsweeps.evaluate_cells(tasks[1], lam, EVAL_LENGTHS, **kw)
    _eval_equal(got, want)
    if case == "srpt":      # no lane: the host kernel on both backends
        return
    lane = tsweeps.evaluate_cells(tasks[1], lam, EVAL_LENGTHS,
                                  backend="torch", device="cpu", **kw)
    with enable_x64():
        want_lane = jsweeps.evaluate_cells(tasks[0], lam, EVAL_LENGTHS,
                                           backend="jax", **kw)
    _eval_equal(lane, want_lane)
    np.testing.assert_allclose(lane.des_system_time, got.des_system_time,
                               rtol=1e-12)


def test_evaluate_solution_threads_the_grid(tasks, grids):
    want, got = grids["mgc"]
    kw = dict(n_seeds=2, n_queries=300, seed=1)
    ev_t = tsweeps.evaluate_solution(tasks[1], _feasible(got), **kw)
    ev_j = jsweeps.evaluate_solution(tasks[0], _feasible(want), **kw)
    _eval_equal(ev_t, ev_j)
    np.testing.assert_array_equal(ev_t.c, got.c[:-1].astype(np.int64))
    assert isinstance(ev_t, tsweeps.GridEvaluation)


def _feasible(sol):
    """The grid without its last (infeasible) cell."""
    return dataclasses.replace(sol, **{
        f.name: getattr(sol, f.name)[:-1] for f in dataclasses.fields(sol)})


@pytest.fixture(scope="module")
def frontiers(tasks):
    jp, tp = jcore.paper_problem(), tcore.paper_problem()
    kw = dict(lengths=[0.0, 340.0, 0.0, 0.0, 345.0, 30.0],
              lams=[0.1, 0.3], sigmas=[0.0, 0.5, 2.0], n_seeds=2,
              n_queries=300, seed=3, window=16)
    return (jsweeps.sweep_prediction_error(jp, **kw),
            tsweeps.sweep_prediction_error(tp, **kw))


def test_sweep_prediction_error_matches_reference(frontiers):
    want, got = frontiers
    assert isinstance(got, tsweeps.PredictionFrontier)
    sw, sg = want.summary(), got.summary()
    assert sg.keys() == sw.keys()
    for k in ("mean_wait", "p99_wait", "ci_mean_wait", "overflow_frac"):
        assert sg[k].keys() == sw[k].keys()
        for d in sw[k]:
            np.testing.assert_allclose(sg[k][d], sw[k][d], rtol=1e-12,
                                       atol=0)
    for k in ("accuracy", "cv2", "sigmas", "lams", "lengths"):
        np.testing.assert_array_equal(sg[k], sw[k])
    assert tsweeps.service_cv2(tcore.paper_problem(), sg["lengths"]) == \
        sw["cv2"]


@pytest.mark.parametrize("metric", ["mean_wait", "p99_wait"])
@pytest.mark.parametrize("discipline", ["spjf", "sprpt"])
def test_fifo_crossover_sigma_matches_reference(frontiers, discipline,
                                                metric):
    want, got = frontiers
    for lam_index in (0, -1):
        w = jsweeps.fifo_crossover_sigma(want, discipline, metric, lam_index)
        g = tsweeps.fifo_crossover_sigma(got, discipline, metric, lam_index)
        assert g == pytest.approx(w, rel=1e-12) or (np.isinf(g)
                                                    and np.isinf(w))


@pytest.mark.parametrize("text", ["", "hello", "queueing ü ∞ 🚀"])
def test_tokenizer_round_trip_matches_reference(text):
    tt, jt = tdata.ByteTokenizer(), jdata.ByteTokenizer()
    for bos, eos in ((True, False), (False, True)):
        ids = tt.encode(text, bos=bos, eos=eos)
        np.testing.assert_array_equal(ids, jt.encode(text, bos=bos, eos=eos))
        assert ids.dtype == np.int32
        assert tt.decode(ids) == jt.decode(ids) == text
    seqs = [tt.encode(text), tt.encode("ab")]
    np.testing.assert_array_equal(tt.pad_batch(seqs), jt.pad_batch(seqs))
    assert tt.vocab_size == jt.vocab_size
