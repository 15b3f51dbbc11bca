"""The paged KV path of the port against ``repro``'s: the paged cache and
decode step, ``BlockAllocator``, and the paged ``ContinuousBatchingEngine``
on ``tests/test_paged.py``'s 10-request fixture.

Both packages run reduced ``qwen3-0.6b`` in f32 on the JAX package's
parameters (carried across with ``from_jax_params``). Tolerances: greedy
tokens, block tables, positions, free lists and occupancy are compared
exactly; logits and pool contents at rtol = atol = 1e-4 (the two packages
sum the same products in other orders, as in ``tests/test_torch_model.py``).
The port's pool has one trash block past the JAX package's ``P`` blocks
(where the JAX package drops a write, the port writes the trash block), so
pools are compared on ``[:, :P]``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import decode_step as j_decode_step
from repro.models import init_params as j_init_params
from repro.models import reduced as j_reduced
from repro.models.attention import init_paged_cache as j_init_paged_cache
from repro.serving.continuous import BlockAllocator as JAllocator
from repro.serving.continuous import ContinuousBatchingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.models import (PagedKVCache, decode_step, init_paged_cache,
                                reduced)
from repro_torch.serving import BlockAllocator, ContinuousBatchingEngine
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
    """``tests/test_paged.py``'s fixture: 10 requests, prompts of 3-19
    tokens, budgets 1-11, 4 answer tokens."""
    rng = np.random.default_rng(0)
    return [(i,
             rng.integers(1, 97, size=int(rng.integers(3, 20))).astype(
                 np.int32),
             int(rng.integers(1, 12)), 4) for i in range(10)]


def drain(eng, reqs, use_step=False, chunk=None):
    """Admit-all/step loop mirroring ``LLMServer._run_continuous``; returns
    the tokens per request and the (tokens_in_use, pool_fill) sampled at
    every chunk boundary."""
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


def _engines(model, **kw):
    jcfg, jparams, cfg, params = model
    return (JEngine(jcfg, jparams, **kw),
            ContinuousBatchingEngine(cfg, params, **kw))


PAGED = dict(max_slots=4, capacity=64, chunk=5, paged=True, block_size=8)


@pytest.fixture(scope="module")
def jax_paged(model, requests):
    """The JAX package's paged drain at chunk 5 (its own tests pin it
    equal to its slot path, to ``step`` and to chunks 1 and 13)."""
    return drain(_engines(model, **PAGED)[0], requests)


# ------------------------------------------------------------- model level
def test_init_paged_cache_shapes(model):
    _, _, cfg, _ = model
    pc = init_paged_cache(cfg, batch=3, n_blocks=10, block_size=4, n_bt=6,
                          device="cpu")
    assert isinstance(pc, PagedKVCache)
    assert pc.k.shape[:3] == (cfg.n_layers, 11, 4)       # + the trash block
    assert pc.block_tables.shape == (3, 6)
    assert pc.block_tables.dtype == torch.int32
    assert bool((pc.block_tables == 10).all())           # all sentinel
    assert pc.n_blocks == 10 and pc.block_size == 4 and pc.capacity == 24
    assert pc.length.tolist() == [0, 0, 0]


@pytest.mark.parametrize("force_ref", [False, True])
def test_paged_decode_step_matches_reference(model, force_ref):
    """Two decode steps over a filled pool with a shuffled block table:
    ragged positions, a slot past its table (its writes dropped) and a
    retired all-sentinel slot (its writes dropped; its logits are compared
    only on the reference path, which attends over the clipped block as the
    JAX package's gather path does)."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(3)
    B, P, bs, n_bt = 4, 20, 4, 5
    L, nkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    pool_k = rng.standard_normal((L, P, bs, nkv, hd)).astype(np.float32)
    pool_v = rng.standard_normal((L, P, bs, nkv, hd)).astype(np.float32)
    perm = rng.permutation(P)
    tables = np.full((B, n_bt), P, np.int32)
    tables[0, :2] = perm[:2]               # pos 6: block 1, then block 2
    tables[1, :5] = perm[2:7]              # pos 19: the table's last slot
    tables[2, :5] = perm[7:12]             # pos 25: past the table
    pos = np.array([6, 19, 25, 3], np.int32)   # row 3 retired (sentinel)
    tables[0, 2] = perm[12]                # step 2 of row 0 needs block 2
    jpc = j_init_paged_cache(jcfg, B, P, bs, n_bt)._replace(
        k=jnp.asarray(pool_k), v=jnp.asarray(pool_v),
        block_tables=jnp.asarray(tables),
        length=jnp.asarray(np.broadcast_to(pos, (L, B))))
    pc = init_paged_cache(cfg, B, P, bs, n_bt, device="cpu")
    pc.k[:, :P] = torch.from_numpy(pool_k)
    pc.v[:, :P] = torch.from_numpy(pool_v)
    pc.block_tables.copy_(torch.from_numpy(tables))
    pc = pc._replace(length=torch.from_numpy(pos.copy()))
    jcache, cache = {"layers": jpc}, {"layers": pc}
    live = slice(None) if force_ref else slice(0, 3)
    for step in range(2):
        tok = np.array([[3 + step], [9], [40 * step], [1]], np.int32)
        jres = j_decode_step(jcfg, jparams, jnp.asarray(tok), jcache,
                             static_layers=True)
        res = decode_step(cfg, params, torch.from_numpy(tok), cache,
                          force_ref=force_ref)
        np.testing.assert_allclose(res.logits.numpy()[live],
                                   np.asarray(jres.logits)[live], **TOL)
        jcache, cache = jres.cache, res.cache
        jl, tl = jcache["layers"], cache["layers"]
        np.testing.assert_allclose(tl.k[:, :P].numpy(), np.asarray(jl.k),
                                   **TOL)
        np.testing.assert_allclose(tl.v[:, :P].numpy(), np.asarray(jl.v),
                                   **TOL)
        np.testing.assert_array_equal(tl.length.numpy(),
                                      np.asarray(jl.length)[0])
        np.testing.assert_array_equal(tl.block_tables.numpy(),
                                      np.asarray(jl.block_tables))


# --------------------------------------------------------------- allocator
def test_block_allocator_churn_matches_reference():
    """The same random reserve/alloc/free churn gives the same free lists,
    allocations and reservations as the JAX package's allocator."""
    rng = np.random.default_rng(7)
    al, jal = BlockAllocator(32), JAllocator(32)
    live = []
    for _ in range(500):
        if live and rng.random() < 0.45:
            blocks, res = live.pop(int(rng.integers(len(live))))
            for a in (al, jal):
                a.free(blocks)
                a.release(res)
        else:
            n = int(rng.integers(1, 6))
            ok = al.reserve(n)
            assert ok == jal.reserve(n)
            if ok:
                blocks = al.alloc(n)
                assert blocks == jal.alloc(n)
                live.append((blocks, n))
        assert al._free == jal._free
        assert (al.reserved, al.n_free, al.n_allocated) \
            == (jal.reserved, jal.n_free, jal.n_allocated)
        held = sum(len(b) for b, _ in live)
        assert al.check_balance(in_use=held)
    for blocks, res in live:
        al.free(blocks)
        al.release(res)
    assert al.n_free == 32 and al.reserved == 0


def test_block_allocator_refuses_what_the_reference_asserts():
    al = BlockAllocator(4)
    assert al.reserve(3) and not al.reserve(2)
    with pytest.raises(AssertionError, match="beyond reservation"):
        al.alloc(5)
    with pytest.raises(AssertionError):
        al.release(4)
    al.free(al.alloc(3))
    with pytest.raises(AssertionError, match="duplicate"):
        al._free.append(al._free[0])
        al.check_balance()


# ------------------------------------------------------------------ engine
def test_paged_engine_matches_reference(model, requests, jax_paged):
    """Tokens identical to the JAX package's paged engine, and the
    occupancy gauges equal at every chunk boundary."""
    got = drain(_engines(model, **PAGED)[1], requests)
    assert got[0] == jax_paged[0]
    assert got[1] == jax_paged[1]
    assert sorted(got[0]) == list(range(10))


@pytest.mark.parametrize("use_step,chunk", [(True, None), (False, 1),
                                            (False, 13)])
def test_paged_step_and_chunks_match_reference(model, requests, jax_paged,
                                               use_step, chunk):
    """``step`` and ``step_chunk`` at chunks 1 and 13: chunk boundaries
    move, tokens don't."""
    eng = _engines(model, **PAGED)[1]
    assert drain(eng, requests, use_step=use_step, chunk=chunk)[0] \
        == jax_paged[0]
    assert eng.check_block_invariants()


def test_paged_matches_slot(model, requests, jax_paged):
    slot = ContinuousBatchingEngine(model[2], model[3], max_slots=4,
                                    capacity=64, chunk=5)
    paged = _engines(model, **PAGED)[1]
    assert paged.pool_tokens == slot.pool_tokens       # equal KV memory
    assert drain(slot, requests)[0] == jax_paged[0]


def test_pool_state_after_admission_matches_reference(model, requests):
    """After one batched admission: the pool's blocks, block tables and
    positions as the JAX package's (pad positions dropped there, written
    to the trash block here)."""
    jeng, eng = _engines(model, **PAGED)
    assert jeng.admit_many(requests[:4]) == eng.admit_many(requests[:4])
    jl, tl = jeng.cache["layers"], eng.cache["layers"]
    P = eng.n_blocks
    np.testing.assert_array_equal(tl.block_tables.numpy(),
                                  np.asarray(jl.block_tables))
    np.testing.assert_array_equal(tl.length.numpy(), np.asarray(jl.length)[0])
    np.testing.assert_allclose(tl.k[:, :P].numpy(), np.asarray(jl.k), **TOL)
    np.testing.assert_allclose(tl.v[:, :P].numpy(), np.asarray(jl.v), **TOL)
    assert [s.tokens for s in eng.slots] == [s.tokens for s in jeng.slots]


def test_pool_exhaustion_queues_not_crashes(model, requests, jax_paged):
    """A 6-block pool: admission refuses what does not fit, the requests
    are offered again as blocks free up, and tokens, free lists and the
    occupancy at every chunk boundary match the JAX package's."""
    kw = dict(max_slots=6, capacity=64, chunk=5, paged=True, block_size=8,
              n_blocks=6)
    jeng, eng = _engines(model, **kw)
    flags = eng.admit_many(requests)
    assert flags == jeng.admit_many(requests)
    assert 0 < sum(flags) < len(requests)      # some admitted, some queued
    rest = [r for r, ok in zip(requests, flags) if not ok]
    want, got = drain(jeng, rest), drain(eng, rest)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert eng.allocator._free == jeng.allocator._free
    assert eng.allocator.n_free == 6 and eng.allocator.reserved == 0
    assert eng.check_block_invariants()
    assert (eng._tables_host == eng.n_blocks).all()
    # back-pressure changes timing only, never tokens
    assert got[0] == jax_paged[0]


def test_free_list_reuse_after_retire(model):
    kw = dict(max_slots=2, capacity=32, chunk=4, paged=True, block_size=8,
              n_blocks=8)
    jeng, eng = _engines(model, **kw)
    prompt = np.arange(1, 9, dtype=np.int32)
    first_blocks = set()
    for e in (jeng, eng):
        assert e.admit(0, prompt, budget=4, max_extra=2)
        seen = set(e._slot_blocks[0])
        while e.n_active:
            e.step_chunk()
            seen |= set(e._slot_blocks[0])
        assert e.allocator.n_free == 8
        assert e.admit(1, prompt, budget=4, max_extra=2)
        first_blocks = seen
    assert eng.check_block_invariants()
    # the freed blocks are handed to the next request (LIFO reuse), the
    # same ones as in the JAX package
    assert set(eng._slot_blocks[0]) & first_blocks
    assert eng._slot_blocks == jeng._slot_blocks
    assert eng.allocator._free == jeng.allocator._free


def test_occupancy_gauges(model, requests):
    eng = _engines(model, **PAGED)[1]
    assert eng.tokens_in_use == 0 and eng.pool_fill == 0.0
    eng.admit_many(requests[:4])
    assert eng.tokens_in_use == sum(s.cache_len for s in eng.slots if s)
    assert 0.0 < eng.pool_fill <= 1.0
    assert eng.blocks_in_use == eng.allocator.n_allocated > 0
    while eng.n_active:
        eng.step_chunk()
    assert eng.tokens_in_use == 0 and eng.blocks_in_use == 0


def test_cpu_engine_launches_nothing(model, requests):
    """On the CPU every attention, paged attention and MLP call takes its
    kernel's plain version: the launch counts stay empty."""
    reset_launches()
    drain(_engines(model, **PAGED)[1], requests[:3])
    assert sum(LAUNCHES.values()) == 0
