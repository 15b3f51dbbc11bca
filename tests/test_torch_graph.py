"""The decode step over static buffers (the CUDA graph's code path) and the
capture / replay / host-read counters of ``repro_torch.obs.graph_hooks``.

On the CPU the engines run the same static-buffer step they capture on a
card, eagerly, counted the same way. Greedy tokens of that chunk path
must equal the eager per-token loop's and the JAX package's engines', at
chunks 1, 4 and 16 and at uneven budgets, for reduced ``qwen3-0.6b``
(``DecodeEngine``, and the continuous engine in slot and paged mode),
reduced ``rwkv6-1.6b`` and the hybrid ``zamba2-7b`` at ``n_layers=5,
attn_every=2`` (the shared block runs twice); the continuous engine's
step also on those two and on reduced ``starcoder2-3b`` (a ring of 64),
whose rows it admits in groups of equal prompt length and whose states
it copies in place, there against the per-token drain only
(``tests/test_torch_continuous_recurrent.py`` holds them to the JAX
engine). The JAX engines' tokens do
not depend on their chunk (``tests/test_engine_fast_path.py``,
``tests/test_paged.py``), so each is computed once. The five cases of
``tests/test_obs_jax_hooks.py`` are ported to ``graph_hooks``, with "one
compile serves all budgets" read as one capture. Logits and cache
contents at rtol = atol = 1e-4 in f32, as in the other parity tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import reduced as j_reduced
from repro.serving import DecodeEngine as JDecodeEngine
from repro.serving.continuous import ContinuousBatchingEngine as JContinuous
from repro_torch import core as tcore
from repro_torch import queueing_sim as tqs
from repro_torch.configs import get_config
from repro_torch.models import decode_step, forward, init_params, reduced
from repro_torch.models.attention import attn_decode_stacked, init_cache
from repro_torch.obs import graph_hooks
from repro_torch.serving import (ContinuousBatchingEngine, DecodeEngine,
                                 LLMServer, ServerConfig)
from repro_torch.weights import from_jax_params
from repro_torch.compat import cap_xdist_threads

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["qwen3-0.6b", "rwkv6-1.6b", "zamba2-7b"]
CHUNKS = [1, 4, 16]


@pytest.fixture(autouse=True)
def _clean_counters():
    graph_hooks.reset()
    yield
    graph_hooks.reset()


def _configs(arch: str):
    """(JAX config, port config): reduced, and for the hybrid 5 layers with
    the shared block every 2."""
    if arch == "zamba2-7b":
        return (dataclasses.replace(j_reduced(j_get_config(arch), n_layers=5),
                                    attn_every=2),
                dataclasses.replace(reduced(get_config(arch), n_layers=5),
                                    attn_every=2))
    return j_reduced(j_get_config(arch)), reduced(get_config(arch))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, cfg = _configs(request.param)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def qwen3():
    jcfg, cfg = _configs("qwen3-0.6b")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, from_jax_params(jax.device_get(jparams),
                                               device="cpu")


# uneven budgets: 0, off every chunk boundary, one past a chunk of 16
PROMPTS = np.arange(3 * 9, dtype=np.int32).reshape(3, 9) % 89 + 2
BUDGETS = [7, 0, 17]
EXTRA = 3


@pytest.fixture(scope="module")
def jax_tokens(model):
    jcfg, jparams, _, _ = model
    return JDecodeEngine(jcfg, jparams, cache_capacity=64, chunk=4).generate(
        PROMPTS, BUDGETS, max_extra_tokens=EXTRA)


# ------------------------------------------------------------ DecodeEngine
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunk_path_matches_loop_and_reference(model, jax_tokens, chunk):
    _, _, cfg, params = model
    eng = DecodeEngine(cfg, params, cache_capacity=64, chunk=chunk)
    got = eng.generate(PROMPTS, BUDGETS, max_extra_tokens=EXTRA)
    loop = eng.generate(PROMPTS, BUDGETS, max_extra_tokens=EXTRA,
                        use_scan=False)
    for key in ("tokens", "n_generated", "n_reasoning"):
        np.testing.assert_array_equal(got[key], loop[key])
        np.testing.assert_array_equal(got[key], jax_tokens[key])
    np.testing.assert_array_equal(got["n_reasoning"], BUDGETS)
    assert graph_hooks.assert_max_captures("engine.chunk", 1) == 1


def test_static_buffers_reload_for_each_request(model):
    """A second request with other prompts and budgets on the same engine
    (the step's buffers loaded, not captured again) gives what a fresh
    engine gives."""
    _, _, cfg, params = model
    other = PROMPTS[:, ::-1].copy()
    eng = DecodeEngine(cfg, params, cache_capacity=64, chunk=4)
    eng.generate(PROMPTS, BUDGETS, max_extra_tokens=EXTRA)
    second = eng.generate(other, [2, 9, 4], max_extra_tokens=1)
    fresh = DecodeEngine(cfg, params, cache_capacity=64, chunk=4).generate(
        other, [2, 9, 4], max_extra_tokens=1)
    for key in ("tokens", "n_generated"):
        np.testing.assert_array_equal(second[key], fresh[key])
    assert graph_hooks.capture_counts()["engine.chunk"] == 2   # two engines


def test_decode_step_advances_positions_in_place(qwen3):
    """The dense cache's 0-d position advances in place: the returned cache
    is the argument's, so a captured step moves the live position."""
    _, _, cfg, params = qwen3
    out = forward(cfg, params, torch.from_numpy(PROMPTS[:, :5]).long(),
                  return_cache=True, cache_capacity=16)
    kv = out.cache["layers"]
    assert kv.length.dim() == 0 and kv.length.dtype == torch.int32
    length = kv.length
    res = decode_step(cfg, params, torch.ones(3, 1, dtype=torch.long),
                      out.cache)
    assert res.cache["layers"] is kv and kv.length is length
    assert int(length) == 6


def test_shared_position_past_capacity_writes_last_slot(qwen3):
    """Prefill 13 tokens into a 16-slot cache, then 5 steps: positions 16
    and 17 lie past the capacity, and like the JAX package's
    ``dynamic_update_slice`` the shared position writes the last slot.
    Logits and the cache as the JAX package's at every step."""
    jcfg, jparams, cfg, params = qwen3
    tokens = np.random.default_rng(1).integers(1, 97, (2, 13))
    jout = j_forward(jcfg, jparams, jnp.asarray(tokens, jnp.int32),
                     return_cache=True, cache_capacity=16)
    out = forward(cfg, params, torch.from_numpy(tokens), return_cache=True,
                  cache_capacity=16)
    jcache, cache = jout.cache, out.cache
    for step in range(5):
        tok = np.array([[5 + step], [3 * step + 1]], np.int32)
        jres = j_decode_step(jcfg, jparams, jnp.asarray(tok), jcache,
                             static_layers=True)
        res = decode_step(cfg, params, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(res.logits.numpy(),
                                   np.asarray(jres.logits), **TOL)
        jcache, cache = jres.cache, res.cache
        np.testing.assert_allclose(cache["layers"].k.numpy(),
                                   np.asarray(jcache["layers"].k), **TOL)
    assert int(cache["layers"].length) == 18


def test_attn_decode_past_capacity_slot_semantics(qwen3):
    """Past the capacity a shared (0-d) position writes the last slot; a
    per-row ([B]) position past it writes that row's old value back."""
    _, _, cfg, params = qwen3
    p = {k: v[0] for k, v in params["blocks"]["attn"].items()}
    C = 8
    x = torch.randn(2, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    for pos in (torch.tensor(C + 3, dtype=torch.int32),
                torch.tensor([C + 3, 2], dtype=torch.int32)):
        kv = init_cache(cfg, 2, C, "cpu")
        kv.k.normal_(generator=torch.Generator().manual_seed(1))
        before = kv.k.clone()
        attn_decode_stacked(cfg, p, x, kv, pos, layer=0)
        changed = (kv.k[0] != before[0]).any(dim=(-1, -2))      # [B, C]
        if pos.dim() == 0:
            assert changed[:, C - 1].all() and not changed[:, :C - 1].any()
        else:
            assert not changed[0].any()              # row 0: past C, kept
            assert changed[1, 2] and changed[1].sum() == 1
        assert torch.equal(kv.k[1:], before[1:])     # other layers untouched


def test_seeded_sampling_reproducible_on_the_chunk_path(qwen3):
    """Stochastic sampling draws from the engine's one generator, reseeded
    per call: two engines with the same seed agree, another seed differs,
    and the chunk path agrees with the per-token loop."""
    _, _, cfg, params = qwen3
    kw = dict(cache_capacity=64, chunk=4, temperature=0.8)
    a = DecodeEngine(cfg, params, **kw).generate(PROMPTS, [9, 5, 6],
                                                 max_extra_tokens=0, seed=3)
    eng = DecodeEngine(cfg, params, **kw)
    b = eng.generate(PROMPTS, [9, 5, 6], max_extra_tokens=0, seed=3)
    loop = eng.generate(PROMPTS, [9, 5, 6], max_extra_tokens=0, seed=3,
                        use_scan=False)
    other = eng.generate(PROMPTS, [9, 5, 6], max_extra_tokens=0, seed=4)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["tokens"], loop["tokens"])
    assert not np.array_equal(a["tokens"], other["tokens"])


# ----------------------------------------------- ContinuousBatchingEngine
REQUESTS = [(i, (np.arange(3 + 4 * i) * (i + 1)) % 89 + 2, b, 3)
            for i, b in enumerate([5, 0, 17, 9, 2, 12])]
CONT = dict(max_slots=3, capacity=64)
PAGED = dict(paged=True, block_size=8, n_blocks=12)   # back-pressured


def _drain(eng, chunk=None, requests=REQUESTS):
    pending, done = list(requests), {}
    while pending or eng.n_active:
        if pending:
            flags = eng.admit_many(pending)
            pending = [r for r, ok in zip(pending, flags) if not ok]
        for s in eng.step_chunk(chunk):
            done[s.rid] = s.tokens
    return done


@pytest.fixture(scope="module")
def jax_continuous(qwen3):
    jcfg, jparams, _, _ = qwen3
    return {mode: _drain(JContinuous(jcfg, jparams, chunk=4, **CONT,
                                     **(PAGED if mode == "paged" else {})))
            for mode in ("slot", "paged")}


@pytest.mark.parametrize("mode", ["slot", "paged"])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_continuous_chunk_path_matches_step_and_reference(
        qwen3, jax_continuous, mode, chunk):
    _, _, cfg, params = qwen3
    kw = dict(CONT, **(PAGED if mode == "paged" else {}))
    got = _drain(ContinuousBatchingEngine(cfg, params, chunk=chunk, **kw))
    per_token = _drain(ContinuousBatchingEngine(cfg, params, chunk=chunk,
                                                **kw), chunk=1)
    assert got == per_token == jax_continuous[mode]
    assert {rid: len(t) for rid, t in got.items()} \
        == {rid: max(b + x, 1) for rid, _, b, x in REQUESTS}
    label = f"continuous.{mode}"
    # one capture in each engine: `chunk`, and the per-token drain's 1
    assert graph_hooks.capture_counts()[label] == 2


# recurrent, hybrid and windowed rows: prompt lengths repeat (groups of
# equal length), one past starcoder2's reduced window of 64 (its ring in
# a capacity of 128)
ROW_ARCHS = ["rwkv6-1.6b", "zamba2-7b", "starcoder2-3b"]
ROW_CONT = dict(max_slots=3, capacity=128)
ROW_REQUESTS = [(i, (np.arange(n) * (i + 2)) % 89 + 2, b, 3)
                for i, (n, b) in enumerate(zip((9, 70, 9, 5, 5, 9),
                                               (5, 0, 17, 9, 2, 12)))]


@pytest.mark.parametrize("arch", ROW_ARCHS)
def test_continuous_rows_chunk_path_matches_step(arch):
    """The static-buffer step over recurrent states (copied in place), the
    hybrid's shared K/V at per-row positions and a windowed ring: the
    chunk path (16) equals the per-token drain, each engine capturing its
    step once. (Both against the JAX engine:
    tests/test_torch_continuous_recurrent.py.)"""
    _, cfg = _configs(arch)
    params = init_params(cfg, seed=0, device="cpu")
    got = _drain(ContinuousBatchingEngine(cfg, params, chunk=16,
                                          **ROW_CONT), requests=ROW_REQUESTS)
    per_token = _drain(ContinuousBatchingEngine(cfg, params, chunk=16,
                                                **ROW_CONT),
                       chunk=1, requests=ROW_REQUESTS)
    assert got == per_token
    assert {rid: len(t) for rid, t in got.items()} \
        == {rid: max(b + x, 1) for rid, _, b, x in ROW_REQUESTS}
    assert graph_hooks.capture_counts()["continuous.slot"] == 2


def test_continuous_one_read_per_chunk(qwen3):
    """Every step_chunk reads the device once (its tokens), every admission
    once (the first tokens), and replays the one capture of its chunk."""
    _, _, cfg, params = qwen3
    eng = ContinuousBatchingEngine(cfg, params, chunk=4, **CONT)
    pending, chunks, admissions = list(REQUESTS), 0, 0
    while pending or eng.n_active:
        if pending:
            flags = eng.admit_many(pending)
            admissions += any(flags)
            pending = [r for r, ok in zip(pending, flags) if not ok]
        eng.step_chunk()
        chunks += 1
    t = graph_hooks.transfer_counts()
    assert t["continuous.slot"] == chunks
    assert t["continuous.admit"] == admissions
    assert graph_hooks.assert_max_captures("continuous.slot", 1) == 1
    assert graph_hooks.replay_counts()["continuous.slot"] == 4 * chunks - 1


# ------------------------------------------------- graph_hooks (jax_hooks)
def _doubler(label):
    """A GraphCache over a static buffer per shape: run(key) doubles it."""
    cache, bufs = graph_hooks.GraphCache(label, "cpu"), {}

    def call(n):
        buf = bufs.setdefault(n, torch.ones(n))
        cache.run(n, lambda: buf.mul_(2))
        return buf
    return call


def test_capture_one_per_shape():
    f = _doubler("hooks.double")
    f(4)
    f(4)
    out = f(4)                                  # same shape: replayed
    assert graph_hooks.capture_counts()["hooks.double"] == 1
    assert graph_hooks.replay_counts()["hooks.double"] == 2
    assert torch.equal(out, torch.full((4,), 8.0))
    f(8)                                        # new shape: captured
    assert graph_hooks.capture_counts()["hooks.double"] == 2


def test_assert_max_captures_raises_on_capture_storm():
    f = _doubler("hooks.storm")
    for n in (2, 3, 4):
        f(n)
    assert graph_hooks.assert_max_captures("hooks.storm", 3) == 3
    with pytest.raises(AssertionError, match="hooks.storm"):
        graph_hooks.assert_max_captures("hooks.storm", 2)


def test_to_host_counts_transfers():
    x = torch.ones(3)
    out = graph_hooks.to_host(x, "hooks.sync")
    np.testing.assert_array_equal(out, np.ones(3))
    graph_hooks.to_host(x, "hooks.sync")
    assert graph_hooks.transfer_counts()["hooks.sync"] == 2
    assert graph_hooks.snapshot()["transfers"]["hooks.sync"] == 2


def test_reset_scoped_and_global():
    _doubler("hooks.a")(2)
    _doubler("hooks.b")(2)
    graph_hooks.reset("hooks.a")
    counts = graph_hooks.capture_counts()
    assert "hooks.a" not in counts and counts["hooks.b"] == 1
    graph_hooks.reset()
    assert graph_hooks.capture_counts() == {}


def test_one_capture_serves_all_budgets(qwen3):
    """The regression of tests/test_obs_jax_hooks.py: ragged budgets and
    chunk-boundary crossings reuse ONE capture of the decode step, and the
    per-token reference loop captures nothing."""
    _, _, cfg, params = qwen3
    eng = DecodeEngine(cfg, params, cache_capacity=64, chunk=4)
    prompts = np.ones((2, 8), dtype=np.int32)
    chunks = 0
    for budgets in ([3, 7], [5, 2], [8, 8], [4, 4], [1, 6]):
        eng.generate(prompts, budgets, max_extra_tokens=0)
        chunks += -(-max(budgets) // 4)
    assert graph_hooks.assert_max_captures("engine.chunk", 1) == 1
    assert graph_hooks.transfer_counts()["engine.chunk"] == chunks
    eng.generate(prompts, [3, 5], max_extra_tokens=0, use_scan=False)
    # a new prompt length reuses the capture: only the prefill's shape moved
    eng.generate(np.ones((2, 16), dtype=np.int32), [3, 5],
                 max_extra_tokens=0)
    assert graph_hooks.assert_max_captures("engine.chunk", 1) == 1


def test_one_capture_serves_a_serve(qwen3):
    """A serve of 3 requests with other budgets and prompt lengths through
    LLMServer: the decode step is captured once, replayed for every other
    step, and the host reads the device once per chunk."""
    _, _, cfg, params = qwen3
    prob = tcore.paper_problem(lam=0.1, alpha=30.0)
    stream = tqs.generate_stream(prob.tasks, 0.1, 3, seed=2)
    eng = DecodeEngine(cfg, params, cache_capacity=256, chunk=16)
    srv = LLMServer(prob, ServerConfig(generate_tokens=True,
                                       max_extra_tokens=4), engine=eng)
    rep = srv.run(stream)
    totals = [c.budget + 4 for c in srv.completed]
    assert len({q.prompt_len for q in stream.queries}) == 3
    assert len({c.budget for c in srv.completed}) > 1
    chunks = sum(-(-t // 16) for t in totals)
    assert graph_hooks.assert_max_captures("engine.chunk", 1) == 1
    assert graph_hooks.transfer_counts()["engine.chunk"] == chunks
    assert graph_hooks.replay_counts()["engine.chunk"] == 16 * chunks - 1
    assert rep.tokens_generated == sum(totals)
