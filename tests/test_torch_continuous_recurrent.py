"""The continuous engine on recurrent, hybrid and sliding-window rows, the
port's against ``repro``'s ``ContinuousBatchingEngine``.

Three reduced models in f32 on the JAX package's parameters
(``from_jax_params``): ``rwkv6-1.6b`` (2 layers), the hybrid ``zamba2-7b``
at ``n_layers=5, attn_every=2`` (the shared block runs twice, one Mamba2
layer remains) and ``starcoder2-3b`` (a sliding window of 64, so the ring
of the engine's 128-position capacity holds 64 slots). None of them may
pad a prompt, so both engines admit each offer in groups of equal prompt
length. The drain's 8 requests repeat three prompt lengths, one of them
(70) longer than the window; 3 slots make every slot hold several
requests in turn, a longer one retiring before a shorter one takes its
slot; budgets carry the windowed rows' decode past the ring's wrap.

Held exactly: the admission groups (slots and request ids, in order) at
the JAX drain's chunk, the greedy tokens of every request at chunks 16
and 1, and the
``ServingReport`` of ``LLMServer(batch_size=4)`` on each engine within
1e-12 (under the virtual clock it is a function of the budgets alone).
The paged pool refuses all three backbones with ``ValueError``, as the
JAX engine's does.
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
from repro.serving.continuous import ContinuousBatchingEngine as JEngine
from repro_torch import core as tcore
from repro_torch import queueing_sim as tqs
from repro_torch import serving as tserving
from repro_torch.configs import get_config
from repro_torch.models import reduced
from repro_torch.serving import ContinuousBatchingEngine
from repro_torch.weights import from_jax_params

ARCHS = ["rwkv6-1.6b", "zamba2-7b", "starcoder2-3b"]
ENGINE = dict(max_slots=3, capacity=128)


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


# prompt lengths 70 (past the reduced window of 64), 12 and 5, each twice
# or three times; request 0 (70 tokens, budget 2) retires in the first
# chunk and a 5-token prompt takes its slot
LENGTHS = (70, 12, 12, 5, 12, 70, 5, 5)
BUDGETS = (2, 9, 30, 14, 5, 1, 20, 7)
REQUESTS = [(i, (np.arange(n) * (i + 3)) % 89 + 2, b, 2)
            for i, (n, b) in enumerate(zip(LENGTHS, BUDGETS))]


def _drain(eng, chunk=None):
    """Offer every pending request at each chunk boundary; returns the
    tokens per request and the admission groups, as [(slot, rid), ...]
    lists in admission order."""
    groups = []
    admit_group = eng._admit_group

    def record(group):
        groups.append([(slot, req[0]) for slot, req in group])
        admit_group(group)
    eng._admit_group = record
    pending, done = list(REQUESTS), {}
    while pending or eng.n_active:
        if pending:
            flags = eng.admit_many(pending)
            pending = [r for r, ok in zip(pending, flags) if not ok]
        for s in eng.step_chunk(chunk):
            done[s.rid] = s.tokens
    return done, groups


@pytest.fixture(scope="module")
def jax_engine(model):
    """One JAX engine per model, so its jitted prefills, insert and chunk
    scan compile once for the drain and the server test; it is empty
    after each."""
    jcfg, jparams, _, _ = model
    return JEngine(jcfg, jparams, chunk=16, **ENGINE)


@pytest.fixture(scope="module")
def jax_drain(jax_engine):
    return _drain(jax_engine)


def test_drain_exercises_groups_refills_and_the_ring(jax_drain):
    """The drain is what the module docstring says: groups of equal
    length, some of several rows, a slot that held a 70-token prompt
    refilled by a 5-token one, and windowed rows decoding past position
    64."""
    _, groups = jax_drain
    lengths = {rid: n for rid, n in enumerate(LENGTHS)}
    assert all(len({lengths[r] for _, r in g}) == 1 for g in groups)
    assert max(len(g) for g in groups) > 1
    held = {}
    refilled = False
    for g in groups:
        for slot, rid in g:
            refilled |= held.get(slot, 0) == 70 and lengths[rid] == 5
            held[slot] = lengths[rid]
    assert refilled
    assert max(n + b + 2 for n, b in zip(LENGTHS, BUDGETS)) > 64 + 1


@pytest.mark.parametrize("chunk", [16, 1])
def test_drain_matches_reference(model, jax_drain, chunk):
    """Greedy tokens of every request equal the JAX engine's, and every
    request emits budget + 2 tokens; at the JAX drain's chunk (16) the
    admission groups are the same too (a group follows the slots free at
    a chunk boundary), per token (chunk 1, ``step``'s) they differ."""
    _, _, cfg, params = model
    got, groups = _drain(ContinuousBatchingEngine(cfg, params, chunk=16,
                                                  **ENGINE), chunk=chunk)
    assert got == jax_drain[0]
    assert {rid: len(t) for rid, t in got.items()} \
        == {rid: b + x for rid, _, b, x in REQUESTS}
    if chunk == 16:
        assert groups == jax_drain[1]


def test_paged_pool_refuses_the_backbone(model):
    jcfg, jparams, cfg, params = model
    with pytest.raises(ValueError, match="paged KV"):
        JEngine(jcfg, jparams, paged=True, **ENGINE)
    with pytest.raises(ValueError, match="paged KV"):
        ContinuousBatchingEngine(cfg, params, paged=True, **ENGINE)


def _problem(core):
    """Budgets of 0, 30 and 64 tokens (l_max 64, lam 0.3, alpha 30)."""
    prob = core.paper_problem()
    return core.Problem(tasks=prob.tasks,
                        server=core.ServerParams(0.3, 30.0, 64.0))


def test_server_on_continuous_engine_matches_reference(model, jax_engine,
                                                       jax_drain):
    """``LLMServer(batch_size=4)`` on each package's continuous engine
    (the JAX one after its drain), 8 arrivals bunched (rate 5) with
    prompts of 5 tokens: the report, occupancy included, within 1e-12 and
    every request's tokens equal."""
    _, _, cfg, params = model
    out = {}
    for name, core, qs, sv, eng in (
            ("jax", jcore, jqs, jserving, jax_engine),
            ("torch", tcore, tqs, tserving,
             ContinuousBatchingEngine(cfg, params, chunk=16, **ENGINE))):
        small = _problem(core)
        stream = qs.generate_stream(small.tasks, 5.0, 8, seed=2,
                                    prompt_len_range=(5, 5))
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
    assert got.n == 8 and got.occupancy["n_samples"] > 0
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
