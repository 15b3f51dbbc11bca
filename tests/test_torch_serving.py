"""The slice as a whole: ``repro_torch.serving.LLMServer`` against
``repro.serving.LLMServer`` on the setup of
``tests/test_serving.py::test_server_with_real_engine`` (l_max 64,
alpha 2, 12 queries, seed 2, prompts of 4-8 tokens).

Under the virtual clock the report is a function of the budgets alone, so
its fields must agree to 1e-12; the model runs on the JAX package's
parameters, so every request's tokens must be identical.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro import core as jcore
from repro import queueing_sim as jqs
from repro import serving as jserving
from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.models import reduced as j_reduced
from repro_torch import core as tcore
from repro_torch import queueing_sim as tqs
from repro_torch import serving as tserving
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import init_params, reduced
from repro_torch.weights import from_jax_params


def _small(core):
    prob = core.paper_problem()
    return core.Problem(tasks=prob.tasks,
                        server=core.ServerParams(0.1, 2.0, 64.0))


def _assert_reports_equal(got, want):
    for f in dataclasses.fields(got):
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


def _record_tokens(srv) -> list:
    """(rid, output tokens) of every request the server's engine runs."""
    seen = []
    orig = srv._engine_work

    def record(batch):
        orig(batch)
        seen.extend((r.rid, list(r.output_tokens)) for r in batch)
    srv._engine_work = record
    return seen


@pytest.fixture(scope="module")
def served():
    jcfg = j_reduced(j_get_config("qwen3-0.6b"))
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("qwen3-0.6b"))
    params = from_jax_params(jax.device_get(jparams), device="cpu")
    out = {}
    for name, core, qs, sv, eng in (
            ("jax", jcore, jqs, jserving,
             jserving.DecodeEngine(jcfg, jparams, cache_capacity=1024)),
            ("torch", tcore, tqs, tserving,
             tserving.DecodeEngine(cfg, params, cache_capacity=1024))):
        small = _small(core)
        stream = qs.generate_stream(small.tasks, 0.1, 12, seed=2,
                                    prompt_len_range=(4, 8))
        srv = sv.LLMServer(small, sv.ServerConfig(generate_tokens=True,
                                                  max_extra_tokens=2,
                                                  online_adaptation=False),
                           engine=eng)
        toks = _record_tokens(srv)
        out[name] = (srv.run(stream), toks, srv)
    return out


def test_server_report_matches_reference(served):
    got, want = served["torch"][0], served["jax"][0]
    assert got.n == 12
    assert got.tokens_generated > 0
    jfields = {f.name for f in dataclasses.fields(want)}
    assert {f.name for f in dataclasses.fields(got)} <= jfields
    # compare the port's fields against the reference's same-named fields
    want_sub = type(got)(**{f.name: getattr(want, f.name)
                            for f in dataclasses.fields(got)})
    _assert_reports_equal(got, want_sub)


def test_server_outputs_identical_tokens(served):
    (_, t_toks, t_srv), (_, j_toks, j_srv) = served["torch"], served["jax"]
    assert len(t_toks) == 12
    assert t_toks == j_toks
    assert [c.rid for c in t_srv.completed] == [c.rid for c in j_srv.completed]
    assert t_srv.allocator.budgets() == j_srv.allocator.budgets()


def test_batched_left_padded_tokens_identical():
    """Batches of 3 ragged prompts, left-padded, through both engines."""
    jcfg = j_reduced(j_get_config("qwen3-0.6b"))
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("qwen3-0.6b"))
    params = from_jax_params(jax.device_get(jparams), device="cpu")
    outs = []
    for core, qs, sv, eng in (
            (jcore, jqs, jserving, jserving.DecodeEngine(
                jcfg, jparams, cache_capacity=128, chunk=4)),
            (tcore, tqs, tserving, tserving.DecodeEngine(
                cfg, params, cache_capacity=128, chunk=4))):
        small = _small(core)
        srv = sv.LLMServer(small, sv.ServerConfig(
            generate_tokens=True, max_extra_tokens=3, batch_size=3,
            online_adaptation=False), engine=eng)
        stream = qs.generate_stream(small.tasks, 0.1, 6, seed=4,
                                    prompt_len_range=(4, 8))
        reqs = _record_tokens(srv)
        srv.run(stream)
        outs.append(sorted(reqs))
    assert outs[0] == outs[1]
    assert all(len(toks) > 0 for _, toks in outs[1])


@pytest.mark.parametrize("discipline", ["sjf", "priority"])
def test_disciplines_match_reference(discipline):
    jp, tp = jcore.paper_problem(), tcore.paper_problem()
    js = jqs.generate_stream(jp.tasks, 0.1, 300, seed=11)
    ts = tqs.generate_stream(tp.tasks, 0.1, 300, seed=11)
    want = jserving.LLMServer(jp, jserving.ServerConfig(
        discipline=discipline, online_adaptation=False)).run(js)
    got = tserving.LLMServer(tp, tserving.ServerConfig(
        discipline=discipline, online_adaptation=False)).run(ts)
    want_sub = type(got)(**{f.name: getattr(want, f.name)
                            for f in dataclasses.fields(got)})
    _assert_reports_equal(got, want_sub)


def test_wall_mode_times_the_engine():
    """``wall`` mode: the service clock is the engine's wall time."""
    cfg = reduced(get_config("qwen3-0.6b"))
    eng = tserving.DecodeEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                                cache_capacity=64, chunk=4)
    small = _small(tcore)
    stream = tqs.generate_stream(small.tasks, 0.1, 4, seed=7,
                                 prompt_len_range=(4, 8))
    srv = tserving.LLMServer(small, tserving.ServerConfig(
        mode="wall", batch_size=2, generate_tokens=True, max_extra_tokens=2,
        online_adaptation=False), engine=eng)
    rep = srv.run(stream)
    assert rep.n == 4
    assert rep.tokens_generated == sum(c.budget + 2 for c in srv.completed)
    virtual = [float(small.tasks.t0[c.task_index]
                     + small.tasks.c[c.task_index] * c.budget)
               for c in srv.completed]
    assert rep.mean_service > 0
    assert [c.service_time for c in srv.completed] != virtual


def test_unported_discipline_raises():
    """All six of the reference's disciplines are ported; any other name
    raises, as in the reference."""
    with pytest.raises(ValueError, match="unknown discipline"):
        tserving.LLMServer(tcore.paper_problem(),
                           tserving.ServerConfig(discipline="lifo"))
    srv = tserving.LLMServer(tcore.paper_problem(),
                             tserving.ServerConfig(discipline="srpt"))
    assert srv.scheduler.discipline == "srpt"


def test_launcher_runs_to_its_end(capsys):
    rep = serve.main(["--reduced", "--device", "cpu", "--real-engine",
                      "--queries", "3"])
    assert rep["n"] == 3
    assert rep["tokens_generated"] > 0
    assert '"allocator_resolves": 1' in capsys.readouterr().out
