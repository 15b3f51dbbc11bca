"""The server's hooks in the port against ``repro``'s: the tracer, the
metrics registry, the admission ladder, the fault injectors, and
``LLMServer`` with all four over the paged continuous engine.

The tracer, metrics, admission and fault modules are host-side NumPy in
both packages, so they are held bitwise: the same calls on the same
inputs give the same events, snapshots, levels, decisions, schedules and
multipliers. ``LLMServer`` runs in virtual mode, where the report is a
function of the budgets, the admission decisions and the fault draws, so
its fields are held at 1e-12 and every request's greedy tokens exactly
(reduced ``qwen3-0.6b`` in f32 on the JAX package's parameters, as in
``tests/test_torch_continuous.py``). The engines' wall spans are compared
by name and arguments (their timestamps are the host's clock).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro import core as jcore
from repro import faults as jfaults
from repro import queueing_sim as jqs
from repro import serving as jserving
from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.models import reduced as j_reduced
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.serving.continuous import BlockAllocator as JAllocator
from repro.serving.continuous import ContinuousBatchingEngine as JEngine
from repro_torch import core as tcore
from repro_torch import faults as tfaults
from repro_torch import queueing_sim as tqs
from repro_torch import serving as tserving
from repro_torch.configs import get_config
from repro_torch.models import reduced
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.serving import BlockAllocator, ContinuousBatchingEngine
from repro_torch.weights import from_jax_params


@pytest.fixture(scope="module")
def model():
    jcfg = j_reduced(j_get_config("qwen3-0.6b"))
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("qwen3-0.6b"))
    params = from_jax_params(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, cfg, params


# ------------------------------------------------------------------ trace
def _script(tr, mod):
    """The same recording calls on a tracer of either package."""
    tr.complete("request", 0.5, 2.0, args={"rid": 7, "task": 1})
    tr.complete("admit", 0.5, 0.25, cat="request", args={"rid": 7})
    tr.complete("prefill", 0.75, 0.5, cat="request", args={"rid": 7})
    tr.complete("decode", 1.25, 1.25, cat="request", args={"rid": 7})
    tr.instant("retire", 2.5, cat="request", args={"rid": 7})
    tr.counter("server.queue_depth", ts_s=0.75, depth=3)
    tr.complete("negative", 3.0, -1.0, tid=2)        # clamped to 0
    with tr.span("engine.prefill", cat="engine", args={"B": 2, "S": 9}):
        pass
    tr.instant("resolve", None, pid=mod.WALL_PID)


def _no_wall_clock(trace: dict) -> list:
    """The events with the wall clock's timestamps and durations taken
    out (virtual-timeline events keep theirs)."""
    out = []
    for ev in trace["traceEvents"]:
        ev = dict(ev)
        if ev.get("pid") == 2:
            ev.pop("ts", None)
            ev.pop("dur", None)
        out.append(ev)
    return out


def test_to_chrome_schema_matches_reference(tmp_path):
    j, t = jtrace.Tracer(), ttrace.Tracer()
    _script(j, jtrace)
    _script(t, ttrace)
    jc, tc = j.to_chrome(), t.to_chrome()
    assert tc.keys() == jc.keys() and tc["displayTimeUnit"] == "ms"
    assert _no_wall_clock(tc) == _no_wall_clock(jc)
    assert len(t) == len(j)
    assert ttrace.spans_by_request(tc) == jtrace.spans_by_request(jc)
    path = t.dump(str(tmp_path / "trace.json"))
    import json
    with open(path) as f:
        assert _no_wall_clock(json.load(f)) == _no_wall_clock(tc)


def test_null_tracer_records_nothing():
    t = ttrace.NullTracer()
    _script(t, ttrace)
    assert len(t) == 0 and t.to_chrome()["traceEvents"] == []
    assert not t.enabled and ttrace.NULL_TRACER.enabled is False


def test_timecall_warmup_excluded():
    calls = []

    def fn(x):
        calls.append(x)
        return x * 2

    out, dt = ttrace.timecall(fn, 21, warmup=3)
    assert out == 42 and len(calls) == 4 and dt >= 0.0
    assert tserving.timecall is ttrace.timecall


def _tree(rid, ts0=1.0, gap=0.0, retire_at=None, drop=None):
    """One request's span tree on the virtual timeline (seconds)."""
    tr = jtrace.Tracer()
    spans = [("request", ts0, 3.0), ("admit", ts0, 1.0),
             ("prefill", ts0 + 1.0 + gap, 0.5),
             ("decode", ts0 + 1.5 + gap, 1.5 - gap)]
    for name, ts, dur in spans:
        if name != drop:
            tr.complete(name, ts, dur, args={"rid": rid})
    if drop != "retire":
        tr.instant("retire", ts0 + 3.0 if retire_at is None else retire_at,
                   args={"rid": rid})
    return tr.to_chrome()


@pytest.mark.parametrize("kind", ["ok", "gap", "missing", "late_retire",
                                  "unknown_rid"])
def test_validate_request_trees_matches_reference(kind):
    trace = {"ok": _tree(3), "gap": _tree(3, gap=0.1),
             "missing": _tree(3, drop="prefill"),
             "late_retire": _tree(3, retire_at=5.0),
             "unknown_rid": _tree(4)}[kind]
    results = []
    for mod in (jtrace, ttrace):
        try:
            results.append(mod.validate_request_trees(trace, [3]))
        except AssertionError as e:
            results.append(("raised", str(e)))
    assert results[1] == results[0]
    assert (kind == "ok") == isinstance(results[0], dict)


# ---------------------------------------------------------------- metrics
def _values(seed: int, n: int = 4000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.lognormal(-1.0, 2.0, n)
    v[rng.random(n) < 0.15] = 0.0            # the wait's atom at zero
    v[rng.random(n) < 0.02] = -1.0           # counted as zeros
    v[:3] = np.nan                           # counted as zeros
    return v


def _snap_tuple(s):
    return dataclasses.astuple(s)


@pytest.mark.parametrize("bits", [0, 3, 5, 8, 12])
def test_histogram_snapshot_and_percentiles_bitwise(bits):
    v = _values(bits)
    hs = []
    for mod in (jmetrics, tmetrics):
        h = mod.StreamingHistogram(bits=bits)
        h.record_many(v[:2500])
        for x in v[2500:2600]:
            h.record(x)
        h.record_many(v[2600:])
        hs.append(h)
    j, t = hs
    assert _snap_tuple(t.snapshot()) == _snap_tuple(j.snapshot())
    qs = (0.0, 1.0, 25.0, 50.0, 90.0, 99.0, 99.9, 100.0)
    assert t.percentiles(qs) == j.percentiles(qs)
    assert t.mean == j.mean and t.n == j.n
    assert t.snapshot().as_dict(qs) == j.snapshot().as_dict(qs)


def test_merge_snapshots_and_lanes_bitwise():
    v = _values(7).reshape(8, 500)
    lanes = {}
    for name, mod in (("jax", jmetrics), ("torch", tmetrics)):
        per = mod.histogram_per_lane(v, axis=0, bits=5)
        merged = mod.merge_snapshots(per)
        whole = mod.StreamingHistogram(5)
        whole.record_many(v)
        folded = mod.StreamingHistogram(5)
        for s in per[::-1]:
            folded.merge_from(s)
        assert _snap_tuple(merged) == _snap_tuple(whole.snapshot())
        assert _snap_tuple(folded.snapshot()) == _snap_tuple(merged)
        lanes[name] = ([_snap_tuple(s) for s in per], _snap_tuple(merged),
                       merged.percentiles())
    assert lanes["torch"] == lanes["jax"]
    with pytest.raises(ValueError):
        tmetrics.merge_snapshots([])
    with pytest.raises(ValueError):
        tmetrics.StreamingHistogram(4).snapshot().merge(
            tmetrics.StreamingHistogram(5).snapshot())
    with pytest.raises(ValueError):
        tmetrics.StreamingHistogram(13)
    with pytest.raises(ValueError):
        tmetrics.StreamingHistogram().record_many([1.0, np.inf])


def test_registry_and_null_registry_match_reference():
    out = {}
    for name, mod in (("jax", jmetrics), ("torch", tmetrics)):
        reg = mod.MetricsRegistry()
        reg.counter("server.requests").inc(3)
        reg.counter("server.requests").inc()
        reg.gauge("server.queue_depth").set(5)
        reg.histogram("server.wait").record_many(_values(2, 300))
        reg.histogram("server.coarse", bits=2).record(0.25)
        out[name] = reg.as_dict()
        null = mod.NullRegistry()
        null.counter("a").inc()
        null.histogram("b").record(1.0)
        assert null.snapshot() == {} and not null.enabled
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------- admission
BASE = np.array([0, 341, 0, 0, 346, 30])
L_MAX = 32768.0

ADMISSION_CASES = {
    "default": dict(),
    "dwell": dict(n_levels=4, dwell_up=0.5, dwell_down=2.0,
                  shed_per_level=(0, 0, 1, 2, 3),
                  class_weights=(1.0, 3.0, 1.0, 0.5, 3.0, 2.0)),
    "tight": dict(n_levels=2, rho_high=0.8, rho_low=0.5, fill_high=0.6,
                  fill_low=0.35, dwell_down=0.0, l_max_decay=0.3, l_min=4),
}


def _trajectory(seed: int, n: int = 400):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(0.4, n))
    rho = np.clip(0.75 + 0.45 * np.sin(t / 15.0)
                  + 0.1 * rng.standard_normal(n), 0.0, 1.5)
    rho[rng.random(n) < 0.03] = np.nan     # an estimator not identified
    fill = np.clip(0.4 + 0.3 * np.cos(t / 9.0), 0.0, 1.0)
    return t, rho, fill, rng.integers(0, 6, n)


@pytest.mark.parametrize("case", sorted(ADMISSION_CASES))
def test_admission_trajectory_bitwise(case):
    """One (time, rho, fill) trajectory through both controllers: the same
    level after every update, the same decision for every request, the
    same block decisions, ladder, metrics counters and snapshot."""
    t, rho, fill, tasks = _trajectory(len(case))
    runs = {}
    for name, sv, mm in (("jax", jserving, jmetrics),
                         ("torch", tserving, tmetrics)):
        reg = mm.MetricsRegistry()
        adm = sv.AdmissionController(
            BASE, L_MAX, sv.AdmissionConfig(**ADMISSION_CASES[case]),
            metrics=reg)
        levels, decisions, blocks = [], [], []
        for i in range(len(t)):
            levels.append(adm.update(t[i], rho[i], fill[i]))
            decisions.append(dataclasses.astuple(adm.decide(int(tasks[i]))))
            if i % 50 == 0:
                ok, budgets, lvl = adm.decide_batch(tasks[i:i + 20])
                blocks.append((ok.tolist(), budgets.tolist(), lvl))
        runs[name] = (levels, decisions, blocks, adm.snapshot(),
                      adm.ladder().tolist(),
                      adm.ladder_l_max(300.0).tolist(), reg.as_dict())
    assert runs["torch"] == runs["jax"]
    snap = runs["torch"][3]
    assert snap["n_level_up"] > 1 and snap["n_level_down"] > 0
    assert snap["n_shed"] > 0


def test_set_ladder_and_shed_decisions_match_reference():
    lad = np.array([[0, 341, 5, 0, 346, 30], [10, 200, 9, 0, 360, 30],
                    [0, 180, 3, 1, 100, 40], [0, 20, 2, 0, 50, 10]])
    out = {}
    for name, sv in (("jax", jserving), ("torch", tserving)):
        adm = sv.AdmissionController(BASE, 300.0, sv.AdmissionConfig(
            shed_per_level=(0, 1, 2, 6)))
        adm.set_ladder(lad)
        seq = []
        for lvl in range(4):
            adm._level = lvl
            seq.append([dataclasses.astuple(adm.decide(k))
                        for k in range(6)])
        out[name] = (adm.ladder().tolist(), seq, adm.snapshot())
    assert out["torch"] == out["jax"]
    assert tserving.SHED_CLASS == jserving.SHED_CLASS == "shed-class"


@pytest.mark.parametrize("bad", [
    dict(n_levels=0), dict(rho_low=0.9, rho_high=0.9),
    dict(fill_low=0.95), dict(l_max_decay=1.0), dict(dwell_up=-1.0),
    dict(l_min=-1), dict(shed_per_level=(0, 1))])
def test_admission_config_validation_matches_reference(bad):
    with pytest.raises(ValueError) as want:
        jserving.AdmissionConfig(**bad)
    with pytest.raises(ValueError) as got:
        tserving.AdmissionConfig(**bad)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------ faults
@dataclasses.dataclass(frozen=True)
class _Trace:
    arrivals: np.ndarray
    types: np.ndarray


@pytest.mark.parametrize("seed", [0, 4, 11])
def test_injector_schedules_bitwise(seed):
    """Every injector's draws from one seed, call after call."""
    a = np.sort(np.random.default_rng(seed).uniform(0, 50, 64))
    out = {}
    for name, fm in (("jax", jfaults), ("torch", tfaults)):
        straggler = fm.StragglerDecode(0.3, 4.0, seed=seed)
        drops = fm.DroppedCompletions(0.25, seed=seed + 1)
        corrupt = {m: fm.ObservationCorruption(0.2, m, seed=seed + 2)
                   for m in ("nan", "inf", "zero", "negative")}
        bank = fm.FaultSet(fm.StragglerDecode(0.2, 5.0, seed=seed + 3),
                           fm.StragglerDecode(0.5, 2.0, seed=seed + 4),
                           fm.ObservationCorruption(0.1, "nan", seed=seed),
                           fm.DroppedCompletions(0.1, seed=seed + 5),
                           fm.ArrivalBurst(10.0, 20.0, 4.0))
        rows = []
        for _ in range(4):
            rows.append(straggler.service_multipliers(a).tolist())
            rows.append(drops.drop_mask(64).tolist())
            for m in sorted(corrupt):
                rows.append(corrupt[m].corrupt_observations(a + 1.0)
                            .tolist())
            rows.append(bank.service_multipliers(a).tolist())
            rows.append(bank.corrupt_observations(a).tolist())
            rows.append(bank.drop_mask(64).tolist())
        trace = _Trace(arrivals=a, types=np.arange(64) % 6)
        burst = fm.ArrivalBurst(10.0, 20.0, 4.0).transform_trace(trace)
        rows.append(burst.arrivals.tolist())
        rows.append(bank.transform_trace(trace).arrivals.tolist())
        assert burst.types is trace.types
        base = fm.FaultInjector()
        rows.append((base.service_multipliers(a).tolist(),
                     base.drop_mask(3).tolist(),
                     base.transform_trace(trace) is trace))
        out[name] = rows
    np.testing.assert_equal(out["torch"], out["jax"])


class _Engine:
    """The one attribute ``PoolPressure`` reads of an engine."""

    def __init__(self, allocator):
        self.allocator = allocator


def test_pool_pressure_reservations_bitwise():
    """``PoolPressure`` on each package's ``BlockAllocator``, with slots
    holding reservations of their own: the same reserve / release
    sequence, step by step, and a balanced allocator after release."""
    out = {}
    for name, fm, alloc_cls in (("jax", jfaults, JAllocator),
                                ("torch", tfaults, BlockAllocator)):
        eng = _Engine(alloc_cls(48))
        pp = fm.PoolPressure(0.4, hold_steps=3, period_steps=4, seed=8)
        bank = fm.FaultSet(pp, fm.FaultSet(fm.PoolPressure(
            0.2, hold_steps=5, period_steps=3, seed=9)))
        seq = []
        for step in range(80):
            if step % 7 == 0:
                eng.allocator.reserve(5)
            if step % 11 == 0 and eng.allocator.reserved >= 5:
                eng.allocator.release(5)
            bank.on_decode_step(eng)
            seq.append((eng.allocator.reserved, eng.allocator.n_free))
        bank.release_all(eng)
        seq.append(eng.allocator.reserved)
        out[name] = seq
    assert out["torch"] == out["jax"]
    assert len({r for r, _ in out["torch"][:-1]}) > 2   # pressure came


@pytest.mark.parametrize("make", [
    lambda fm: fm.ArrivalBurst(2.0, 1.0, 2.0),
    lambda fm: fm.ArrivalBurst(0.0, 1.0, 0.5),
    lambda fm: fm.StragglerDecode(1.5, 2.0),
    lambda fm: fm.StragglerDecode(0.5, 0.5),
    lambda fm: fm.PoolPressure(1.0),
    lambda fm: fm.ObservationCorruption(0.1, "bogus"),
    lambda fm: fm.ObservationCorruption(2.0),
    lambda fm: fm.DroppedCompletions(-0.1)])
def test_injector_validation_matches_reference(make):
    with pytest.raises(ValueError) as want:
        make(jfaults)
    with pytest.raises(ValueError) as got:
        make(tfaults)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------- scheduler
@pytest.mark.parametrize("discipline", ["fifo", "sjf", "priority"])
def test_scheduler_budget_cap_matches_reference(discipline):
    out = {}
    for name, core, sv in (("jax", jcore, jserving),
                           ("torch", tcore, tserving)):
        alloc = core.TokenBudgetAllocator(core.paper_problem())
        sched = sv.Scheduler(alloc, discipline)
        for i, (task, cap) in enumerate([(1, 100), (4, None), (5, 7),
                                         (1, 400), (4, 0), (5, None)]):
            sched.admit(sv.Request(rid=i, task_index=task,
                                   prompt=np.arange(4), arrival_t=float(i)),
                        float(i), budget_cap=cap)
        order = []
        while len(sched):
            r = sched.next_request()
            order.append((r.rid, r.budget))
        out[name] = order
    assert out["torch"] == out["jax"]
    assert dict(out["torch"])[0] == 100 and dict(out["torch"])[4] == 0


# ------------------------------------------------------------------ server
def _hot_problem(core):
    """Budgets of 0, 30 and 64 tokens (l_max 64, lam 0.3, alpha 30), as in
    ``tests/test_torch_continuous.py``."""
    prob = core.paper_problem()
    return core.Problem(tasks=prob.tasks,
                        server=core.ServerParams(0.3, 30.0, 64.0))


def _anchored_rate(core, prob) -> float:
    """2x the service rate at the deployed budgets (the reference's
    ``tests/test_faults.py::test_admission_sheds_under_sustained_overload``
    overload)."""
    lengths = np.asarray(core.solve(prob).lengths_int, dtype=np.float64)
    tasks = prob.tasks
    es = float(np.sum(np.asarray(tasks.pi, dtype=np.float64)
                      * (np.asarray(tasks.t0, dtype=np.float64)
                         + np.asarray(tasks.c, dtype=np.float64) * lengths)))
    return 2.0 / es


HOOKS_ENGINE = dict(max_slots=4, capacity=128, chunk=4, paged=True,
                    block_size=8, n_blocks=24)


def _hooked_server(core, qs, sv, fm, mm, tm, eng, n_queries=24):
    """LLMServer(batch_size 4) with the four hooks over ``eng``: a ladder
    on the deployed budgets, an allocator whose rate estimate follows the
    stream within a few arrivals and never re-solves (the reference's
    overload test freezes the re-solver the same way), stragglers and
    pool pressure."""
    prob = _hot_problem(core)
    reg, tracer = mm.MetricsRegistry(), tm.Tracer()
    eng.tracer = tracer             # the engine's wall spans, same trace
    alloc = core.TokenBudgetAllocator(prob, ewma_halflife=2.0,
                                      min_resolve_interval=10 ** 9)
    adm = sv.AdmissionController(
        alloc.solution.lengths_int, prob.server.l_max,
        sv.AdmissionConfig(n_levels=3, rho_high=0.9, rho_low=0.7,
                           dwell_down=1e9), metrics=reg)
    faults = fm.FaultSet(fm.PoolPressure(0.3, hold_steps=2, period_steps=3,
                                         seed=8),
                         fm.StragglerDecode(0.25, 3.0, seed=4))
    srv = sv.LLMServer(prob, sv.ServerConfig(
        generate_tokens=True, batch_size=4, max_extra_tokens=2),
        engine=eng, allocator=alloc, tracer=tracer, metrics=reg,
        admission=adm, faults=faults)
    stream = qs.generate_stream(prob.tasks, _anchored_rate(core, prob),
                                n_queries, seed=3, prompt_len_range=(4, 8))
    seen = []
    orig = srv._engine_work

    def record(batch):
        orig(batch)
        seen.extend((r.rid, r.budget, list(r.output_tokens)) for r in batch)
    srv._engine_work = record
    rep = srv.run(stream)
    return rep, seen, srv, reg, tracer, stream


@pytest.fixture(scope="module")
def hooked(model):
    jcfg, jparams, cfg, params = model
    out = {}
    for name, core, qs, sv, fm, mm, tm, eng in (
            ("jax", jcore, jqs, jserving, jfaults, jmetrics, jtrace,
             JEngine(jcfg, jparams, **HOOKS_ENGINE)),
            ("torch", tcore, tqs, tserving, tfaults, tmetrics, ttrace,
             ContinuousBatchingEngine(cfg, params, **HOOKS_ENGINE))):
        out[name] = _hooked_server(core, qs, sv, fm, mm, tm, eng)
    return out


def test_hooked_server_report_matches_reference(hooked):
    got, want = hooked["torch"][0], hooked["jax"][0]
    assert {f.name for f in dataclasses.fields(got)} == \
        {f.name for f in dataclasses.fields(want)}
    assert got.n_shed > 0 and got.n + got.n_shed == 24
    assert got.degradation_occupancy.keys() >= {"0", "3"}
    assert got.drift is None
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, dict):
            assert a.keys() == b.keys(), f.name
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-12,
                                           atol=1e-12, err_msg=f.name)
        elif isinstance(b, float):
            assert a == pytest.approx(b, rel=1e-12, abs=1e-12), f.name
        else:
            assert a == b, f.name


def test_hooked_server_tokens_budgets_and_sheds_match(hooked):
    (_, t_seen, t_srv, *_), (_, j_seen, j_srv, *_) = \
        hooked["torch"], hooked["jax"]
    assert t_seen == j_seen
    assert [dataclasses.astuple(c) for c in t_srv.shed] == \
        [dataclasses.astuple(c) for c in j_srv.shed]
    assert t_srv.admission.snapshot() == j_srv.admission.snapshot()
    ladder = t_srv.admission.ladder()
    for c in t_srv.shed:
        assert c.n_tokens == 0 and c.budget == 0 and c.service_time == 0.0
    for c in t_srv.completed:                  # exact, and within the cap
        assert c.n_tokens == c.budget + 2
        assert c.budget <= ladder[0, c.task_index]
    assert min(c.budget for c in t_srv.completed
               if c.task_index == 1) < ladder[0, 1]   # the ladder bit
    eng = t_srv.engine
    assert eng.faults is t_srv.faults           # handed to the engine
    t_srv.faults.release_all(eng)
    assert eng.check_block_invariants()
    assert eng.allocator.n_free == eng.allocator.n_blocks
    assert eng.allocator.reserved == 0


def test_hooked_server_metrics_and_trace_match(hooked):
    (_, _, t_srv, t_reg, t_tr, stream), (_, _, _, j_reg, j_tr, _) = \
        hooked["torch"], hooked["jax"]
    assert t_reg.as_dict() == j_reg.as_dict()
    snap = t_reg.as_dict()
    assert snap["server.shed"] == snap["admission.shed"] > 0
    assert snap["server.requests"] == len(t_srv.completed)
    tc, jc = t_tr.to_chrome(), j_tr.to_chrome()
    rids = [c.rid for c in t_srv.completed]
    assert ttrace.validate_request_trees(tc, rids) == \
        jtrace.validate_request_trees(jc, rids)
    virtual = [ev for ev in _no_wall_clock(tc) if ev.get("pid") != 2]
    assert virtual == [ev for ev in _no_wall_clock(jc)
                       if ev.get("pid") != 2]
    # the engines' wall spans: the same names and arguments in order
    def wall(trace):
        return [(ev["name"], ev.get("args")) for ev in trace["traceEvents"]
                if ev.get("pid") == 2 and ev["ph"] == "X"]
    assert wall(tc) == wall(jc)
    names = {n for n, _ in wall(tc)}
    assert names == {"continuous.admit", "continuous.decode_chunk"}
    assert len(stream.queries) == 24


def test_server_without_hooks_reports_defaults(model):
    """No admission: the report's shed fields keep their defaults, and the
    hooked engine's hooks stay off when the server has none."""
    _, _, cfg, params = model
    prob = _hot_problem(tcore)
    eng = ContinuousBatchingEngine(cfg, params, **HOOKS_ENGINE)
    srv = tserving.LLMServer(prob, tserving.ServerConfig(
        generate_tokens=True, batch_size=4, max_extra_tokens=2), engine=eng)
    rep = srv.run(tqs.generate_stream(prob.tasks, 1.0, 6, seed=3,
                                      prompt_len_range=(4, 8)))
    assert rep.n == 6 and rep.n_shed == 0 and rep.shed_fraction == 0.0
    assert rep.degradation_occupancy is None and rep.drift is None
    assert eng.faults is None and eng.tracer is None and srv.shed == []


# ----------------------------------------------------- engines under faults
PRESSURE_REQUESTS = 10


def _pressure_requests():
    """``tests/test_faults.py::test_engine_pool_pressure_no_leaks``'s
    requests: 10 prompts of 3-19 tokens, budgets 1-11, 4 answer tokens."""
    rng = np.random.default_rng(0)
    return [(i, rng.integers(1, 97, size=int(rng.integers(3, 20))).astype(
        np.int32), int(rng.integers(1, 12)), 4)
        for i in range(PRESSURE_REQUESTS)]


def _pressure_drain(eng):
    """The drain, recording which requests each chunk boundary admitted
    and the most blocks an outside tenant held (reserved beyond the
    slots' reservations)."""
    pending, done, admitted, held = list(_pressure_requests()), {}, [], 0
    while pending or eng.n_active:
        if pending:
            flags = eng.admit_many(pending)
            admitted.append([r[0] for r, ok in zip(pending, flags) if ok])
            pending = [r for r, ok in zip(pending, flags) if not ok]
        held = max(held, eng.allocator.reserved - sum(eng._slot_reserved))
        for s in eng.step_chunk():
            done[s.rid] = s.tokens
    return done, admitted, held


def test_pool_pressure_drain_no_leaks_matches_reference(model):
    """Reference ``tests/test_faults.py::test_engine_pool_pressure_no_leaks``
    on the port: under block-pool pressure the tokens equal the unfaulted
    drain's (back-pressure changes admission, never content), the pool
    audit balances after release, and the admissions, chunk by chunk,
    equal the JAX engine's under the same fault schedule."""
    jcfg, jparams, cfg, params = model
    kw = dict(max_slots=4, capacity=64, chunk=5, paged=True, block_size=8)

    def bank(fm):
        return fm.FaultSet(fm.PoolPressure(0.4, hold_steps=3,
                                           period_steps=4, seed=8))
    ref, _, no_tenant = _pressure_drain(ContinuousBatchingEngine(
        cfg, params, **kw))
    faults = bank(tfaults)
    eng = ContinuousBatchingEngine(cfg, params, faults=faults, **kw)
    out, adm, held = _pressure_drain(eng)
    assert out == ref
    assert no_tenant == 0 and held > 0            # the pressure came
    faults.release_all(eng)
    assert eng.check_block_invariants()
    assert eng.allocator.n_free == eng.allocator.n_blocks
    assert eng.allocator.reserved == 0
    jeng = JEngine(jcfg, jparams, faults=bank(jfaults), **kw)
    j_out, j_adm, j_held = _pressure_drain(jeng)
    assert adm == j_adm and held == j_held
    assert out == {k: [int(t) for t in v] for k, v in j_out.items()}


def test_step_runs_the_fault_hook_once(model):
    """``step`` and ``step_chunk`` each fire ``on_decode_step`` once, idle
    or not, as the JAX engine's do."""
    _, _, cfg, params = model
    calls = []

    class Count(tfaults.FaultInjector):
        def on_decode_step(self, engine):
            calls.append(engine.n_active)

    eng = ContinuousBatchingEngine(cfg, params, max_slots=2, capacity=32,
                                   chunk=3, faults=Count())
    eng.step()
    eng.step_chunk()
    assert eng.admit(0, np.arange(1, 6), 4, 1)
    eng.step()
    eng.step_chunk(2)
    assert calls == [0, 0, 1, 1]


def test_decode_engine_spans_match_reference(model):
    """``DecodeEngine(tracer=)``: the ``engine.prefill`` and
    ``engine.decode_chunk`` spans, with their arguments, as the JAX
    engine records them; no span without a tracer."""
    jcfg, jparams, cfg, params = model
    prompts = np.arange(18, dtype=np.int32).reshape(2, 9) % 89 + 2
    spans = {}
    for name, eng_cls, p, c, tm in (
            ("jax", jserving.DecodeEngine, jparams, jcfg, jtrace),
            ("torch", tserving.DecodeEngine, params, cfg, ttrace)):
        tr = tm.Tracer()
        eng = eng_cls(c, p, cache_capacity=64, chunk=4, tracer=tr)
        out = eng.generate(prompts, [9, 2], max_extra_tokens=2)
        spans[name] = ([(ev["name"], ev.get("args"))
                        for ev in tr.to_chrome()["traceEvents"]
                        if ev["ph"] == "X"], out["tokens"].tolist())
    assert spans["torch"] == spans["jax"]
    names = [n for n, _ in spans["torch"][0]]
    assert names[0] == "engine.prefill" and names.count(
        "engine.decode_chunk") == 3
