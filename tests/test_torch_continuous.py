"""The continuous-batching path of the port against ``repro``'s: the
per-row stacked decode step, ``ContinuousBatchingEngine`` in slot mode,
``LLMServer`` on the engine (slot and paged), and seeded sampling.

Both packages run reduced ``qwen3-0.6b`` in f32 on the JAX package's
parameters. Tolerances: greedy tokens and occupancy exactly; logits and
cache contents at rtol = atol = 1e-4 (sums in other orders, as in
``tests/test_torch_model.py``); the ``ServingReport`` at 1e-12 (under the
virtual clock it is a function of the budgets alone). Seeded sampling
cannot match ``jax.random`` bitwise, so the port's draws are held to the
JAX package's contract (chunk-invariant, paged = slot) and to the softmax
in distribution.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro import core as jcore
from repro import queueing_sim as jqs
from repro import serving as jserving
from repro.configs import get_config as j_get_config
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import reduced as j_reduced
from repro.serving.continuous import ContinuousBatchingEngine as JEngine
from repro_torch import core as tcore
from repro_torch import queueing_sim as tqs
from repro_torch import serving as tserving
from repro_torch.configs import get_config
from repro_torch.models import decode_step, fold_sample, forward, reduced
from repro_torch.serving import ContinuousBatchingEngine, DecodeEngine
from repro_torch.weights import from_jax_params
from repro_torch.compat import cap_xdist_threads

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    jcfg = j_reduced(j_get_config("qwen3-0.6b"))
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config("qwen3-0.6b"))
    params = from_jax_params(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def requests():
    """``tests/test_paged.py``'s 10-request fixture."""
    rng = np.random.default_rng(0)
    return [(i,
             rng.integers(1, 97, size=int(rng.integers(3, 20))).astype(
                 np.int32),
             int(rng.integers(1, 12)), 4) for i in range(10)]


def drain(eng, reqs, use_step=False, chunk=None):
    """Admit-all/step loop; tokens per request and the (tokens_in_use,
    pool_fill) at every chunk boundary."""
    pending = list(reqs)
    done, occupancy = {}, []
    while pending or eng.n_active:
        if pending:
            flags = eng.admit_many(pending)
            pending = [r for r, ok in zip(pending, flags) if not ok]
        occupancy.append((eng.tokens_in_use, eng.pool_fill))
        for s in (eng.step() if use_step else eng.step_chunk(chunk)):
            done[s.rid] = s
    return {k: v.tokens for k, v in done.items()}, occupancy


SLOT = dict(max_slots=4, capacity=64, chunk=5)


@pytest.fixture(scope="module")
def jax_slot(model, requests):
    jcfg, jparams, _, _ = model
    return drain(JEngine(jcfg, jparams, **SLOT), requests)


# ------------------------------------------------------------- model level
def test_per_row_stacked_decode_matches_reference(model):
    """Per-row positions on the stacked slot cache, one row past the
    capacity (the JAX package drops its write; the port writes the old
    value back): logits, cache and positions as the JAX package's."""
    jcfg, jparams, cfg, params = model
    tokens = np.random.default_rng(1).integers(1, 97, (3, 9))
    C = 16
    jout = j_forward(jcfg, jparams, jnp.asarray(tokens, jnp.int32),
                     return_cache=True, cache_capacity=C)
    out = forward(cfg, params, torch.from_numpy(tokens), return_cache=True,
                  cache_capacity=C)
    pos = np.array([9, 4, C], np.int32)
    jkv = jout.cache["layers"]
    jkv = jkv._replace(length=jnp.asarray(
        np.broadcast_to(pos, (cfg.n_layers, 3))))
    kv = out.cache["layers"]._replace(length=torch.from_numpy(pos.copy()))
    jcache, cache = {"layers": jkv}, {"layers": kv}
    for step in range(2):
        tok = np.array([[3 + step], [7], [11]], np.int32)
        jres = j_decode_step(jcfg, jparams, jnp.asarray(tok), jcache,
                             static_layers=True)
        res = decode_step(cfg, params, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(res.logits.numpy(),
                                   np.asarray(jres.logits), **TOL)
        jcache, cache = jres.cache, res.cache
        jl, tl = jcache["layers"], cache["layers"]
        np.testing.assert_allclose(tl.k.numpy(), np.asarray(jl.k), **TOL)
        np.testing.assert_allclose(tl.v.numpy(), np.asarray(jl.v), **TOL)
        np.testing.assert_array_equal(tl.length.numpy(),
                                      np.asarray(jl.length)[0])


# ------------------------------------------------------------------ engine
def test_slot_engine_matches_reference(model, requests, jax_slot):
    eng = ContinuousBatchingEngine(model[2], model[3], **SLOT)
    got = drain(eng, requests)
    assert got[0] == jax_slot[0]
    assert got[1] == jax_slot[1]
    assert sorted(got[0]) == list(range(10))
    assert eng.check_block_invariants()         # True: a slot engine


@pytest.mark.parametrize("use_step,chunk", [(True, None), (False, 1),
                                            (False, 13)])
def test_slot_step_and_chunks_match_reference(model, requests, jax_slot,
                                              use_step, chunk):
    eng = ContinuousBatchingEngine(model[2], model[3], **SLOT)
    assert drain(eng, requests, use_step=use_step, chunk=chunk)[0] \
        == jax_slot[0]


def test_rolling_batch_matches_served_alone(model):
    """Requests joining mid-flight into freed slots produce the tokens they
    produce alone through ``DecodeEngine``."""
    _, _, cfg, params = model
    alone = DecodeEngine(cfg, params, cache_capacity=64)
    prompts = [np.arange(1, 7), np.arange(3, 12), np.arange(2, 5),
               np.arange(4, 9)]
    budgets = [5, 3, 7, 4]
    refs = []
    for pr, b in zip(prompts, budgets):
        out = alone.generate(pr[None, :], [b], max_extra_tokens=2)
        refs.append(out["tokens"][0, :out["n_generated"][0]].tolist())
    cb = ContinuousBatchingEngine(cfg, params, max_slots=3, capacity=64,
                                  chunk=3)
    reqs = [(i, prompts[i], budgets[i], 2) for i in range(4)]
    assert cb.admit_many(reqs) == [True, True, True, False]
    done = drain(cb, reqs[3:])[0]
    assert [done[rid] for rid in range(4)] == refs


@pytest.mark.parametrize("paged", [False, True])
def test_degenerate_budget_retires_without_overrun(model, paged):
    """budget + max_extra <= 1: the prefill's first token is the request."""
    _, _, cfg, params = model
    for stepper in (lambda cb: cb.step(), lambda cb: cb.step_chunk(2)):
        cb = ContinuousBatchingEngine(cfg, params, max_slots=2, capacity=64,
                                      paged=paged, block_size=8)
        cb.admit_many([(0, np.arange(1, 5), 1, 0), (1, np.arange(1, 5), 0, 0)])
        done = {}
        while cb.n_active:
            done.update((s.rid, s.tokens) for s in stepper(cb))
        assert len(done[0]) == 1 and len(done[1]) == 1
        assert cb.check_block_invariants()


def test_slot_prompt_past_capacity_raises(model):
    _, _, cfg, params = model
    cb = ContinuousBatchingEngine(cfg, params, max_slots=1, capacity=8)
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        cb.admit(0, np.arange(1, 12), 2)


# ------------------------------------------------------------------ server
def _problem(core):
    """Budgets of 0, 30 and 64 tokens (l_max 64, lam 0.3, alpha 30)."""
    prob = core.paper_problem()
    return core.Problem(tasks=prob.tasks,
                        server=core.ServerParams(0.3, 30.0, 64.0))


@pytest.mark.parametrize("engine_kw", [
    dict(max_slots=4, capacity=128, chunk=4),
    dict(max_slots=4, capacity=128, chunk=4, paged=True, block_size=8,
         n_blocks=12),
], ids=["slot", "paged"])
def test_server_on_continuous_engine_matches_reference(model, engine_kw):
    """``LLMServer`` at batch size 4 on the continuous engine, with the
    arrivals bunched (rate 5) so the batches fill. The paged pool of 12
    blocks holds one worst-case request of budget 64, so admission is
    back-pressured. The report, occupancy included, within 1e-12 and every
    request's tokens identical."""
    jcfg, jparams, cfg, params = model
    out = {}
    for name, core, qs, sv, eng in (
            ("jax", jcore, jqs, jserving,
             JEngine(jcfg, jparams, **engine_kw)),
            ("torch", tcore, tqs, tserving,
             ContinuousBatchingEngine(cfg, params, **engine_kw))):
        small = _problem(core)
        stream = qs.generate_stream(small.tasks, 5.0, 12, seed=2,
                                    prompt_len_range=(4, 8))
        srv = sv.LLMServer(small, sv.ServerConfig(
            generate_tokens=True, batch_size=4, max_extra_tokens=2,
            online_adaptation=False), engine=eng)
        seen = []
        orig = srv._engine_work

        def record(batch, orig=orig, seen=seen):
            orig(batch)
            seen.extend((r.rid, list(r.output_tokens)) for r in batch)
        srv._engine_work = record
        out[name] = (srv.run(stream), seen)
    (got, t_toks), (want, j_toks) = out["torch"], out["jax"]
    assert got.n == 12 and got.occupancy["n_samples"] > 0
    assert t_toks == j_toks
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


# ---------------------------------------------------------------- sampling
SAMPLED = [(0, np.arange(1, 7), 5, 2), (1, np.arange(3, 12), 6, 2),
           (2, np.arange(2, 5), 4, 2)]


def _sampled(model, stepper, max_slots=3, reqs=SAMPLED, paged=False):
    _, _, cfg, params = model
    cb = ContinuousBatchingEngine(cfg, params, max_slots=max_slots,
                                  capacity=64, chunk=3, temperature=0.7,
                                  seed=3, paged=paged, block_size=8)
    pending, out = list(reqs), {}
    while pending or cb.n_active:
        if pending:
            ok = cb.admit_many(pending)
            pending = [r for r, f in zip(pending, ok) if not f]
        out.update((s.rid, s.tokens) for s in stepper(cb))
    return out


def test_seeded_sampling_chunk_invariant(model):
    """Token g of request rid depends on (seed, rid, g) only: the same
    streams under ``step``, any chunk, fewer slots, served alone, and in
    the paged pool."""
    ref = _sampled(model, lambda cb: cb.step())
    assert sorted(ref) == [0, 1, 2]
    assert len({tuple(t) for t in ref.values()}) == 3
    for chunk in (1, 3, 7):
        assert _sampled(model, lambda cb, c=chunk: cb.step_chunk(c)) == ref
    assert _sampled(model, lambda cb: cb.step_chunk(3), max_slots=2) == ref
    for r in SAMPLED:
        assert _sampled(model, lambda cb: cb.step_chunk(4), max_slots=1,
                        reqs=[r])[r[0]] == ref[r[0]]
    assert _sampled(model, lambda cb: cb.step_chunk(), paged=True) == ref


def _chi2_pvalue(counts, probs):
    """Pearson chi-square p-value, categories of expected count < 5 pooled."""
    expected = probs * counts.sum()
    big = expected >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    return stats.chisquare(obs, exp).pvalue


def test_fold_sample_matches_softmax_in_distribution():
    """40000 draws (distinct request ids, and distinct emission indices)
    against softmax(logits / T), beside the JAX package's fold_in draws
    for the same (seed, rid, g); both pass a chi-square test at 1e-3."""
    logits = np.array([2.0, 1.0, 0.5, 0.0, -1.0, 3.0, -4.0], np.float32)
    T, n, seed = 0.7, 40000, 5
    probs = np.exp(logits / T - (logits / T).max())
    probs /= probs.sum()
    lt = torch.from_numpy(logits).expand(n, -1)
    ids = torch.arange(n)
    by_rid = fold_sample(lt, seed, ids, torch.zeros_like(ids), T).numpy()
    by_g = fold_sample(lt, seed, torch.full_like(ids, 17), ids, T).numpy()
    base = jax.random.PRNGKey(seed)
    jdraw = jax.vmap(lambda r: jax.random.categorical(
        jax.random.fold_in(jax.random.fold_in(base, r), 0),
        jnp.asarray(logits) / T))(jnp.arange(n))
    for draws in (by_rid, by_g, np.asarray(jdraw)):
        counts = np.bincount(draws, minlength=len(logits)).astype(float)
        assert _chi2_pvalue(counts, probs) > 1e-3


def test_engine_first_tokens_match_softmax_in_distribution(model):
    """First tokens of 1536 requests with one prompt (distinct ids) through
    the engine's admission against the softmax of the prompt's logits."""
    _, _, cfg, params = model
    prompt = np.arange(1, 9)
    logits = forward(cfg, params, torch.from_numpy(prompt)[None]).logits
    probs = torch.softmax(logits[0, -1].double() / 0.7, -1).numpy()
    cb = ContinuousBatchingEngine(cfg, params, max_slots=128, capacity=16,
                                  temperature=0.7, seed=1)
    firsts = []
    for start in range(0, 1536, 128):
        assert all(cb.admit_many([(rid, prompt, 0, 1)
                                  for rid in range(start, start + 128)]))
        firsts += [s.tokens[0] for s in cb.step_chunk(1)]
    counts = np.bincount(firsts, minlength=len(probs)).astype(float)
    assert _chi2_pvalue(counts, probs) > 1e-3
