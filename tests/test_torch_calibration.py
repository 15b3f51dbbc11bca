"""The port's calibration, occupancy (batch-service) and M/G/c modules
against ``repro.core``'s on the same NumPy inputs, and the paper's model,
``qwen3-8b``, against the JAX package's.

The NumPy functions (``fit_latency``, ``fit_accuracy``,
``calibrate_taskset``, ``fit_step_latency``, ``occupancy_fixed_point``,
``corrected_taskset``, ``batch_service_wait``, ``erlang_c_np``,
``mgc_wait_np``) are the reference's code: bitwise equal. The torch
float64 ones (``erlang_c``, ``mean_wait_mgc``, ``objective_mgc``,
``solve_mgc`` with the gradient from autograd) at rtol = atol = 1e-12
against the JAX package run inside ``enable_x64``; ``solve_mgc`` also
takes the same number of iterations. Reduced ``qwen3-8b`` logits within
1e-4 in f32 of the JAX model on the JAX package's parameters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.compat import enable_x64
from repro.configs import get_config as j_get_config
from repro.core import mgc as jmgc
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import reduced as j_reduced
from repro.serving import DecodeEngine as JDecodeEngine
from repro_torch import core as tcore
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import mgc as tmgc
from repro_torch.models import decode_step, forward, reduced
from repro_torch.serving import DecodeEngine
from repro_torch.weights import from_jax_params
from repro_torch.compat import cap_xdist_threads

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

F64 = dict(rtol=1e-12, atol=1e-12)
rng = np.random.default_rng


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _tasksets_equal(a, b):
    assert tuple(a.names) == tuple(b.names)
    for f in ("A", "b", "D", "t0", "c", "pi"):
        np.testing.assert_array_equal(_np(getattr(a, f)),
                                      _np(getattr(b, f)))


# ------------------------------------------------------------- calibration
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_latency_matches_reference(seed):
    r = rng(seed)
    x = r.uniform(0, 2000, 40)
    y = 0.1 + 0.012 * x + r.normal(0, 0.05, 40)
    assert dataclasses.asdict(tcore.fit_latency(x, y)) \
        == dataclasses.asdict(jcore.fit_latency(x, y))


def test_fit_latency_clips_like_reference():
    """A falling line clips c to 1e-9; a negative intercept clips t0 to 0."""
    x = np.arange(10.0)
    for y in (5.0 - x, -1.0 + 2 * x):
        assert dataclasses.asdict(tcore.fit_latency(x, y)) \
            == dataclasses.asdict(jcore.fit_latency(x, y))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_accuracy_matches_reference(seed):
    r = rng(seed)
    x = np.linspace(0, 4000, 25)
    A, b, D = r.uniform(0.2, 0.7), 10 ** r.uniform(-4, -2), r.uniform(0, .3)
    y = A * (1 - np.exp(-b * x)) + D + r.normal(0, 0.01, x.size)
    got, want = tcore.fit_accuracy(x, y), jcore.fit_accuracy(x, y)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_calibrate_taskset_matches_reference():
    r = rng(3)
    grid = np.array([0, 64, 256, 1024, 4096], np.float64)
    acc = np.clip(0.3 + 0.5 * (1 - np.exp(-grid[None] * r.uniform(
        1e-4, 1e-2, (4, 1)))) + r.normal(0, .01, (4, 5)), 0, 1)
    lat = 0.05 + r.uniform(0.01, 0.02, (4, 1)) * grid[None] \
        + r.normal(0, 0.01, (4, 5))
    names = ("a", "b", "c", "d")
    _tasksets_equal(tcore.calibrate_taskset(names, grid, acc, lat),
                    jcore.calibrate_taskset(names, grid, acc, lat))
    pi = np.array([0.1, 0.2, 0.3, 0.4])
    _tasksets_equal(tcore.calibrate_taskset(names, grid, acc, lat, pi),
                    jcore.calibrate_taskset(names, grid, acc, lat, pi))


# ----------------------------------------------------------- batch service
def test_fit_step_latency_matches_reference():
    b = np.array([1, 2, 4, 8], np.float64)
    for t in (0.010 + 0.0004 * b + rng(0).normal(0, 1e-4, 4),
              0.02 - 0.001 * b):                    # falling: d1 clamped
        got, want = tcore.fit_step_latency(b, t), jcore.fit_step_latency(b, t)
        assert (got.d0, got.d1) == (want.d0, want.d1)
    with pytest.raises(ValueError):
        tcore.fit_step_latency([1.0], [0.01])


LENGTHS = np.array([0.0, 340.5, 0.0, 0.0, 345.0, 30.1])


@pytest.mark.parametrize("lam", [0.05, 0.1, 0.5, 3.0])
@pytest.mark.parametrize("max_batch", [1, 4, 8])
def test_occupancy_and_batch_service_wait_match_reference(lam, max_batch):
    model_t = tcore.StepLatencyModel(d0=0.011, d1=0.0007)
    model_j = jcore.StepLatencyModel(d0=0.011, d1=0.0007)
    tasks_t, tasks_j = tcore.paper_tasks(), jcore.paper_tasks()
    with enable_x64():
        want_fp = jcore.occupancy_fixed_point(tasks_j, LENGTHS, lam,
                                              model_j, max_batch)
        want = {corr: jcore.batch_service_wait(tasks_j, LENGTHS, lam,
                                               model_j, max_batch,
                                               correction=corr)
                for corr in jmgc.MGC_CORRECTIONS}
        want_c = jcore.corrected_taskset(tasks_j, model_j, want_fp[0])
    got_fp = tcore.occupancy_fixed_point(tasks_t, LENGTHS, lam, model_t,
                                         max_batch)
    assert got_fp == want_fp
    _tasksets_equal(tcore.corrected_taskset(tasks_t, model_t, got_fp[0]),
                    want_c)
    for corr, w in want.items():
        got = tcore.batch_service_wait(tasks_t, LENGTHS, lam, model_t,
                                       max_batch, correction=corr)
        assert tuple(got) == tuple(w)


# -------------------------------------------------------------------- mgc
def test_erlang_c_np_and_mgc_wait_np_match_reference():
    c = np.array([1, 2, 3, 4, 8])[:, None]
    a = np.linspace(0.0, 7.5, 16)[None]
    np.testing.assert_array_equal(tcore.erlang_c_np(c, a),
                                  jcore.erlang_c_np(c, a))
    L = rng(4).uniform(0, 800, (5, 3, 6))
    lam = np.array([0.05, 0.2, 1.0])[None, :]
    for corr in tmgc.MGC_CORRECTIONS:
        np.testing.assert_array_equal(
            tcore.mgc_wait_np(tcore.paper_tasks(), L, lam, c, corr),
            jcore.mgc_wait_np(jcore.paper_tasks(), L, lam, c, corr))


@pytest.mark.parametrize("correction", ["lee-longton", "cosmetatos"])
@pytest.mark.parametrize("c", [1, 2, 4])
def test_mgc_objective_matches_reference(correction, c):
    lengths = rng(c).uniform(0, 600, (4, 6))
    pt, pj = tcore.paper_problem(), jcore.paper_problem()
    L = torch.from_numpy(lengths)
    with enable_x64():
        jl = jnp.asarray(lengths)
        want = [np.asarray(f(pj, jl, c, correction=correction))
                for f in (jmgc.mean_wait_mgc, jmgc.mean_system_time_mgc,
                          jmgc.objective_mgc)]
        want_ec = np.asarray(jmgc.erlang_c(c, jnp.linspace(0.0, c, 7)))
    got = [f(pt, L, c, correction=correction).numpy()
           for f in (tcore.mean_wait_mgc, tcore.mean_system_time_mgc,
                     tcore.objective_mgc)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **F64)
    np.testing.assert_allclose(
        tcore.erlang_c(c, torch.linspace(0.0, c, 7,
                                         dtype=torch.float64)).numpy(),
        want_ec, **F64)


def test_mgc_batched_servers_match_reference():
    """A per-cell server count with the grid-wide c_max."""
    lengths = rng(9).uniform(0, 500, (3, 6))
    c = np.array([1, 2, 5])
    with enable_x64():
        want = np.asarray(jmgc.mean_wait_mgc(
            jcore.paper_problem(), jnp.asarray(lengths), jnp.asarray(c),
            c_max=5))
    got = tcore.mean_wait_mgc(tcore.paper_problem(),
                              torch.from_numpy(lengths), torch.from_numpy(c),
                              c_max=5)
    np.testing.assert_allclose(got.numpy(), want, **F64)


def test_objective_mgc_at_one_server_is_the_paper_objective():
    L = torch.from_numpy(rng(5).uniform(0, 600, (6, 6)))
    p = tcore.paper_problem()
    np.testing.assert_allclose(tcore.objective_mgc(p, L, 1).numpy(),
                               tcore.objective(p, L).numpy(), **F64)


@pytest.mark.parametrize("c", [1, 2, 4])
def test_solve_mgc_matches_reference(c):
    with enable_x64():
        want = jcore.solve_mgc(jcore.paper_problem(), c)
    got = tcore.solve_mgc(tcore.paper_problem(), c)
    np.testing.assert_allclose(got.lengths.numpy(),
                               np.asarray(want.lengths), **F64)
    np.testing.assert_allclose(float(got.value), float(want.value), **F64)
    assert got.iterations == want.iterations


def test_pod_replica_tradeoff_matches_reference():
    with enable_x64():
        want = jmgc.pod_replica_tradeoff(jcore.paper_problem(),
                                         max_replicas=2)
    got = tmgc.pod_replica_tradeoff(tcore.paper_problem(), max_replicas=2)
    for (c, j, l), (wc, wj, wl) in zip(got, want):
        assert c == wc
        np.testing.assert_allclose(j, wj, **F64)
        np.testing.assert_allclose(l, wl, **F64)


# ---------------------------------------------------------------- qwen3-8b
def test_qwen3_8b_config_matches_reference():
    assert "qwen3-8b" in ARCH_IDS
    cfg, jcfg = get_config("qwen3-8b"), j_get_config("qwen3-8b")
    for f in dataclasses.fields(cfg):
        if f.name in ("moe", "ssm", "rwkv"):   # None: a dense model reads
                                                # none of them
            assert getattr(cfg, f.name) is None
            continue
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab_size) == (36, 4096, 32, 8, 128, 12288,
                                          151936)
    assert cfg.qk_norm and not cfg.tie_embeddings
    assert cfg.source == "arXiv:2505.09388"


@pytest.fixture(scope="module")
def qwen3_8b():
    jcfg = j_reduced(j_get_config("qwen3-8b"))
    cfg = reduced(get_config("qwen3-8b"))
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, from_jax_params(jax.device_get(jparams),
                                               device="cpu")


def test_qwen3_8b_logits_match_reference(qwen3_8b):
    """Reduced qwen3-8b: prefill logits and three decode steps within 1e-4
    of the JAX model on its own parameters."""
    jcfg, jparams, cfg, params = qwen3_8b
    tokens = rng(6).integers(1, cfg.vocab_size, (2, 13))
    jout = j_forward(jcfg, jparams, jnp.asarray(tokens, jnp.int32),
                     return_cache=True, cache_capacity=32)
    out = forward(cfg, params, torch.from_numpy(tokens), return_cache=True,
                  cache_capacity=32)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits),
                               rtol=1e-4, atol=1e-4)
    jcache, cache = jout.cache, out.cache
    for step in range(3):
        tok = np.array([[11 + step], [40 * step + 2]], np.int32)
        jres = j_decode_step(jcfg, jparams, jnp.asarray(tok), jcache,
                             static_layers=True)
        res = decode_step(cfg, params, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(res.logits.numpy(),
                                   np.asarray(jres.logits),
                                   rtol=1e-4, atol=1e-4)
        jcache, cache = jres.cache, res.cache


def test_qwen3_8b_engine_matches_reference(qwen3_8b):
    """Greedy tokens through DecodeEngine (the static-buffer chunk path)
    equal the JAX engine's, budgets exact."""
    jcfg, jparams, cfg, params = qwen3_8b
    prompts = np.arange(2 * 7, dtype=np.int32).reshape(2, 7) % 50 + 1
    want = JDecodeEngine(jcfg, jparams, cache_capacity=64, chunk=4).generate(
        prompts, [6, 3], max_extra_tokens=2)
    got = DecodeEngine(cfg, params, cache_capacity=64, chunk=4).generate(
        prompts, [6, 3], max_extra_tokens=2)
    for key in ("tokens", "n_generated", "n_reasoning"):
        np.testing.assert_array_equal(got[key], want[key])
