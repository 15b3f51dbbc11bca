"""The rest of the port's ``core`` against ``repro.core`` under x64.

``hessian`` (eqs 33-34), ``grad_autodiff``, the Lemma 2 bound matrix
(eq 25) and the sampled contraction modulus, the paper's fixed-step PGA
(eq 29; its iterates after a fixed number of steps with ``tol=0``, and
one instance that converges in ~1600 steps), the host analytics
(Cobham's priority waits, the largest stable budget, the retry fixed
point) and the ``objective_fn`` / ``grad_fn`` / ``c_servers`` hooks the
M/G/c grid passes. The JAX package runs in f32 outside ``enable_x64``,
so every reference call is made inside it.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.compat import enable_x64
from repro.core import fixed_point as jfp
from repro_torch import core as tcore
from repro_torch.core import fixed_point as tfp
from repro_torch.compat import cap_xdist_threads

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

# the packages export the function ``objective`` under the module's name
jobj = importlib.import_module("repro.core.objective")
tobj = importlib.import_module("repro_torch.core.objective")

F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _both(**server):
    return (jcore.paper_problem(**server), tcore.paper_problem(**server))


# the paper's instance; a light one whose whole box is stable
# (rho_max < 1, so the paper-form bounds are finite); a loaded one
SERVERS = {"paper": dict(lam=0.1, alpha=30.0, l_max=32768.0),
           "box_stable": dict(lam=0.1, alpha=30.0, l_max=100.0),
           "loaded": dict(lam=0.4, alpha=60.0, l_max=1024.0)}
# budgets: interior, at zero, at the paper's optimum
POINTS = {"interior": [120.0, 340.0, 60.0, 10.0, 345.0, 30.0],
          "zero": [0.0] * 6,
          "lstar": [0.0, 340.5, 0.0, 0.0, 345.0, 30.1]}


def test_core_exports_cover_reference():
    assert set(jcore.__all__) <= set(tcore.__all__)
    for name in ("jacobian_bound_matrix", "empirical_contraction_estimate"):
        assert hasattr(tfp, name)
    assert hasattr(tobj, "grad_autodiff")


@pytest.mark.parametrize("point", sorted(POINTS))
@pytest.mark.parametrize("server", sorted(SERVERS))
def test_hessian_matches_reference(server, point):
    jp, tp = _both(**SERVERS[server])
    l = np.asarray(POINTS[point])
    with enable_x64():
        want = np.asarray(jcore.hessian(jp, jnp.asarray(l)))
    got = tcore.hessian(tp, _t(l)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("server", sorted(SERVERS))
def test_grad_autodiff_matches_grad_and_reference(server):
    """Autograd against the analytic gradient, on a batch of allocations
    (leading axes), and against ``jax.grad`` of the reference."""
    jp, tp = _both(**SERVERS[server])
    l = np.stack([np.asarray(v) for v in POINTS.values()])
    got = tobj.grad_autodiff(tp, _t(l)).numpy()
    np.testing.assert_allclose(got, tcore.grad(tp, _t(l)).numpy(),
                               rtol=1e-10, atol=1e-14)
    with enable_x64():
        want = np.stack([np.asarray(jobj.grad_autodiff(jp, jnp.asarray(r)))
                         for r in l])
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("margin", [None, 5e-2])
@pytest.mark.parametrize("server", sorted(SERVERS))
def test_jacobian_bound_matrix_matches_reference(server, margin):
    jp, tp = _both(**SERVERS[server])
    with enable_x64():
        want = np.asarray(jfp.jacobian_bound_matrix(jp, margin))
    got = tfp.jacobian_bound_matrix(tp, margin).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9, atol=0)
    if margin is None and server == "box_stable":
        assert fin.all()


@pytest.mark.parametrize("seed", [0, 3])
def test_empirical_contraction_estimate_matches_reference(seed):
    """Same seed, same sampled points: the Jacobian's sup norm (forward
    mode through the unrolled Lambert-W Newton steps here, the custom
    JVP there) within 1e-9."""
    jp, tp = _both(lam=0.1, alpha=30.0, l_max=32768.0)
    with enable_x64():
        want = float(jfp.empirical_contraction_estimate(jp, n_samples=4,
                                                        seed=seed))
    got = float(tfp.empirical_contraction_estimate(tp, n_samples=4,
                                                   seed=seed))
    assert got == pytest.approx(want, rel=1e-9)


def test_solve_pga_fixed_steps_match_reference():
    """``tol=0`` and 2,000 steps: the step size and every lane's iterate
    after them, one lane and a batch of four starts."""
    jp, tp = _both(lam=0.1, alpha=30.0, l_max=32768.0)
    l0 = np.linspace(0.0, 300.0, 4)[:, None] * np.ones((1, 6))
    with enable_x64():
        j1 = jcore.solve_pga(jp, tol=0.0, max_iters=2000)
        jb = jcore.solve_pga(jp, l0=jnp.asarray(l0), tol=0.0, max_iters=2000)
        j1 = jax.tree_util.tree_map(np.asarray, j1)
        jb = jax.tree_util.tree_map(np.asarray, jb)
    t1 = tcore.solve_pga(tp, tol=0.0, max_iters=2000)
    tb = tcore.solve_pga(tp, l0=_t(l0), tol=0.0, max_iters=2000)
    assert float(t1.eta) == pytest.approx(float(j1.eta), rel=1e-12)
    for t, j in ((t1, j1), (tb, jb)):
        assert t.lengths.shape == j.lengths.shape
        assert int(t.iterations.amax()) == int(j.iterations) == 2000
        np.testing.assert_allclose(t.lengths.numpy(), j.lengths,
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(t.grad_norm.numpy(), j.grad_norm,
                                   rtol=1e-8, atol=1e-12)
    # a lane of the batch is the single run from the same start
    np.testing.assert_array_equal(tb.lengths[0].numpy(), t1.lengths.numpy())


def test_solve_pga_converges_like_reference():
    """l_max 100 keeps the whole box stable, so eta = 2/L_J is usable and
    the fixed-step ascent converges (about 1,600 steps at tol 1e-6)."""
    jp, tp = _both(**SERVERS["box_stable"])
    with enable_x64():
        j = jax.tree_util.tree_map(np.asarray,
                                   jcore.solve_pga(jp, tol=1e-6))
    t = tcore.solve_pga(tp, tol=1e-6)
    assert bool(t.converged) and bool(j.converged)
    assert int(t.iterations) == int(j.iterations)
    np.testing.assert_allclose(t.lengths.numpy(), j.lengths, rtol=1e-10,
                               atol=1e-10)
    with enable_x64():
        ref = np.asarray(jcore.solve_fixed_point(jp, tol=1e-10).lengths)
    np.testing.assert_allclose(t.lengths.numpy(), ref, atol=0.5)


def test_fixed_point_counts_each_lane():
    """Leading axes: every lane's count is its own, and their max is the
    reference's shared loop counter."""
    jp, tp = _both(lam=0.1, alpha=30.0, l_max=32768.0)
    l0 = np.random.default_rng(0).uniform(0, 500, size=(3, 6))
    with enable_x64():
        jb = jcore.solve_fixed_point(jp, l0=jnp.asarray(l0), tol=1e-10)
        lanes = [int(jcore.solve_fixed_point(jp, l0=jnp.asarray(r),
                                             tol=1e-10).iterations)
                 for r in l0]
        jl = np.asarray(jb.lengths)
    tb = tcore.solve_fixed_point(tp, l0=_t(l0), tol=1e-10)
    assert tb.iterations.tolist() == lanes
    for i, row in enumerate(l0):    # each lane is its own run, bitwise
        one = tcore.solve_fixed_point(tp, l0=_t(row), tol=1e-10)
        np.testing.assert_array_equal(tb.lengths[i].numpy(),
                                      one.lengths.numpy())
    assert int(tb.iterations.amax()) == int(jb.iterations)
    np.testing.assert_allclose(tb.lengths.numpy(), jl, rtol=1e-10,
                               atol=1e-10)


def _lambertw_all_steps(z):
    """``tcore.lambertw0``'s Newton iteration run for all of its steps."""
    from repro_torch.core import lambertw as lw

    eps = torch.finfo(z.dtype).tiny
    logz = torch.log(torch.clamp(z, min=eps))
    w = torch.where(z < 0.3, torch.clamp(z * (1.0 - z), min=0.0),
                    torch.where(z < 20.0, torch.log1p(z),
                                logz - torch.log(torch.clamp(logz, min=1.0))))
    for _ in range(lw._NEWTON_ITERS):
        safe_w = torch.clamp(w, min=eps)
        step_log = safe_w * (logz - safe_w - torch.log(safe_w)) / (1.0 + safe_w)
        ew = torch.exp(torch.clamp(w, max=50.0))
        step_direct = -(w * ew - z) / torch.clamp(ew * (1.0 + w), min=eps)
        w = torch.clamp(w + torch.where(w > 1e-3, step_log, step_direct),
                        min=0.0)
    return torch.where(z == 0.0, torch.zeros_like(w), w)


def test_lambertw_settle_is_bitwise():
    """The Newton loop that freezes settled elements and stops early
    returns all of its steps' result bit for bit, at 0, NaN, inf, across
    600 decades and on the fixed point's own arguments (those of the
    paper's instance at its optimum)."""
    rng = np.random.default_rng(1)
    z = np.concatenate([[0.0, np.nan, np.inf, 1e-320],
                        np.logspace(-300, 300, 1500),
                        rng.uniform(0.0, 5.0, 1500)])
    zt = _t(z)
    np.testing.assert_array_equal(tcore.lambertw0(zt).numpy(),
                                  _lambertw_all_steps(zt).numpy())
    tp = tcore.paper_problem()
    l = _t(np.stack([np.asarray(v) for v in POINTS.values()]))
    L, K = tfp.coefficients(tp, l)
    logz = torch.log(tp.tasks.b * L) - tp.tasks.b * K
    zf = torch.exp(torch.clamp(logz, max=700.0))
    np.testing.assert_array_equal(tcore.lambertw0(zf).numpy(),
                                  _lambertw_all_steps(zf).numpy())


def test_fixed_point_cells_are_scalar_solves():
    """Per-cell scalars (``[C]`` lambda, alpha, l_max over ``[C, N]`` task
    arrays, as ``sweeps.solve_grid`` builds them): each lane bitwise equal
    to the scalar solve of its cell, counts too, through the loop's
    dropping of frozen lanes (three cells never converge)."""
    from repro_torch.sweeps.solver_grid import TaskArrays

    cells = [(0.05, 30.0, 32768.0), (0.2, 30.0, 1024.0), (0.4, 60.0, 32768.0),
             (1.0, 30.0, 32768.0), (0.3, 10.0, 1024.0), (2.0, 30.0, 1024.0),
             (0.1, 45.0, 32768.0)]
    lam, alpha, l_max = (_t(x) for x in zip(*cells))
    base = TaskArrays.from_taskset(tcore.paper_problem().tasks)
    ta = base._replace(**{f: getattr(base, f).expand(len(cells), 6)
                          for f in ("A", "b", "D", "t0", "c")})
    prob = tcore.Problem(tasks=ta,
                         server=tcore.ServerParams(lam, alpha, l_max))
    got = tcore.solve_fixed_point(prob)
    assert int((~got.converged).sum()) == 3
    for i, (la, al, lm) in enumerate(cells):
        one = tcore.solve_fixed_point(tcore.paper_problem(la, al, lm))
        np.testing.assert_array_equal(got.lengths[i].numpy(),
                                      one.lengths.numpy())
        assert int(got.iterations[i]) == int(one.iterations)
        assert float(got.residual[i]) == float(one.residual)


LSTAR = [0.0, 341.0, 0.0, 0.0, 346.0, 30.0]
PRIORITY_CASES = {"default_keys": None, "fifo_keys": np.zeros(6),
                  "two_classes": np.array([0, 1, 0, 1, 0, 1.0])}


@pytest.mark.parametrize("lam", [0.1, 0.3])
@pytest.mark.parametrize("keys", sorted(PRIORITY_CASES))
def test_priority_mean_waits_match_reference(keys, lam):
    jp, tp = _both()
    k = PRIORITY_CASES[keys]
    want = jcore.priority_mean_waits(jp.tasks, LSTAR, lam, keys=k)
    got = tcore.priority_mean_waits(tp.tasks, LSTAR, lam, keys=k)
    for f in ("per_task", "mean_wait", "residual"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got.class_of, want.class_of)


@pytest.mark.parametrize("server", sorted(SERVERS))
def test_max_stable_budget_matches_reference(server):
    jp, tp = _both(**SERVERS[server])
    for margin in (1e-3, 0.2):
        with enable_x64():   # its jnp sums are f32 outside
            want = jcore.max_stable_budget(jp, margin)
        assert tcore.max_stable_budget(tp, margin) == pytest.approx(
            want, rel=1e-12, abs=1e-12)


# (lam, E[S], E[S^2], patience): no patience, saturated, zero patience,
# the tail, and a near-deterministic service
TIMEOUT_CASES = [(0.5, 1.0, 2.0, np.inf), (1.2, 1.0, 2.0, 5.0),
                 (0.5, 1.0, 2.0, 0.0), (0.5, 1.0, 2.0, 3.0),
                 (0.9, 1.0, 1.0, 30.0)]


@pytest.mark.parametrize("case", range(len(TIMEOUT_CASES)))
def test_timeout_probability_matches_reference(case):
    args = TIMEOUT_CASES[case]
    assert tcore.timeout_probability(*args) == pytest.approx(
        jcore.timeout_probability(*args), rel=1e-12, abs=1e-15)


# (lam, E[S], E[S^2], patience, K): converged, the retry storm, no retry,
# infinite patience
RETRY_CASES = [(0.5, 1.0, 2.0, 30.0, 3), (0.95, 1.0, 2.0, 2.0, 3),
               (0.5, 1.0, 2.0, 3.0, 0), (0.5, 1.0, 2.0, np.inf, 4),
               (0.7, 1.0, 1.5, 5.0, 1)]


@pytest.mark.parametrize("case", range(len(RETRY_CASES)))
def test_retry_fixed_point_matches_reference(case):
    args = RETRY_CASES[case]
    want = jcore.retry_fixed_point(*args)
    got = tcore.retry_fixed_point(*args)
    assert isinstance(got, tcore.RetryFixedPoint)
    for f in ("lam_eff", "p_timeout", "rho_eff"):
        assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                rel=1e-12, abs=1e-15), f
    assert (got.stable, got.converged) == (want.stable, want.converged)


@pytest.mark.parametrize("patience,retries", [(30.0, 3), (0.5, 3),
                                              (np.inf, 2)])
def test_retry_stable_matches_reference(patience, retries):
    jp, tp = _both()
    for lam in (0.1, 0.5, 1.0):
        assert tcore.retry_stable(tp.tasks, LSTAR, lam, patience, retries) \
            == jcore.retry_stable(jp.tasks, LSTAR, lam, patience, retries)


def test_stabilizable_batched_with_tensor_servers():
    """Leading axes and a tensor ``c_servers``, against the reference."""
    jp, tp = _both()
    lam = np.array([1.0, 5.0, 9.0, 12.0])
    c = np.array([1.0, 1.0, 2.0, 2.0])
    with enable_x64():
        want = np.asarray(jcore.stabilizable(jp.tasks, jnp.asarray(lam),
                                             c_servers=jnp.asarray(c)))
    got = tcore.stabilizable(tp.tasks, _t(lam), c_servers=_t(c)).numpy()
    np.testing.assert_array_equal(got, want)
    assert bool(tcore.stabilizable(tp.tasks, 0.1))


def _mgc_hooks(core, c: int):
    return lambda p, v: core.objective_mgc(p, v, c)


@pytest.mark.parametrize("c", [1, 2])
def test_objective_hooks_through_mgc_closure(c):
    """``solve_pga_backtracking``, ``round_policy`` and
    ``exhaustive_policy`` with the M/G/c objective at c servers and its
    gradient (``jax.grad`` there, autograd here), iterates clipped into
    the c-server slab: the same optimum, iterations and integer points."""
    jp, tp = _both(lam=0.4 * c, alpha=30.0, l_max=32768.0)
    jobj_fn, tobj_fn = _mgc_hooks(jcore, c), _mgc_hooks(tcore, c)

    def tgrad(p, v):
        v = v.detach().requires_grad_(True)
        return torch.autograd.grad(torch.sum(tobj_fn(p, v)), v)[0]

    with enable_x64():
        jg = jax.grad(lambda v: jobj_fn(jp, v))
        j = jcore.solve_pga_backtracking(
            jp, tol=1e-8, eta0=1e3, objective_fn=jobj_fn,
            grad_fn=lambda p, v: jg(v), c_servers=c)
        jl = np.asarray(j.lengths)
        jr = jcore.round_policy(jp, j.lengths, objective_fn=jobj_fn)
        je = jcore.exhaustive_policy(jp, j.lengths, objective_fn=jobj_fn)
        jr, je = ((np.asarray(r.lengths), float(r.value)) for r in (jr, je))
        j_it = int(j.iterations)
    t = tcore.solve_pga_backtracking(
        tp, tol=1e-8, eta0=1e3, objective_fn=tobj_fn, grad_fn=tgrad,
        c_servers=c)
    assert int(t.iterations) == j_it
    np.testing.assert_allclose(t.lengths.numpy(), jl, rtol=1e-9, atol=1e-9)
    for got, (wl, wv) in ((tcore.round_policy(tp, t.lengths,
                                              objective_fn=tobj_fn), jr),
                          (tcore.exhaustive_policy(tp, t.lengths,
                                                   objective_fn=tobj_fn),
                           je)):
        np.testing.assert_array_equal(got.lengths.numpy(), wl)
        assert float(got.value) == pytest.approx(wv, rel=1e-12)
    # the c-server slab: lam E[S] < c at the optimum
    assert float(tcore.service_moments(tp.tasks, t.lengths,
                                       tp.server.lam).rho) < c


def test_backtracking_per_lane_budgets_freeze_lanes():
    """A batch of starts with per-lane budgets: a lane with budget 0 comes
    back clipped and uncounted, the others match their single runs
    bitwise, step size included."""
    _, tp = _both(lam=0.4, alpha=60.0, l_max=1024.0)
    l0 = np.stack([np.zeros(6), np.full(6, 200.0), np.full(6, 50.0)])
    budget = torch.tensor([20_000, 0, 7])
    tb = tcore.solve_pga_backtracking(tp, l0=_t(l0), max_iters=budget)
    assert tb.iterations.tolist()[1:] == [0, 7]
    clipped = tcore.stability_clip(tp.tasks, tp.server.lam, _t(l0[1]), 1e-6)
    np.testing.assert_array_equal(tb.lengths[1].numpy(), clipped.numpy())
    for i, b in ((0, 20_000), (2, 7)):
        one = tcore.solve_pga_backtracking(tp, l0=_t(l0[i]), max_iters=b)
        assert int(one.iterations) == int(tb.iterations[i])
        np.testing.assert_array_equal(tb.lengths[i].numpy(),
                                      one.lengths.numpy())
        assert float(tb.eta[i]) == float(one.eta)
