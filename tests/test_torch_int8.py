"""The int8 KV cache of the port against ``repro``'s: quantisation, the
slot cache (``QuantKVCache``), the int8 paged pool, and both engines.

Reduced ``qwen3-0.6b`` in f32 with ``kv_cache_dtype="int8"`` runs in both
packages on the JAX package's parameters (``from_jax_params``).

Tolerances, and why:

* ``_quantize`` and ``_dequantize`` on identical inputs: bitwise (the same
  f32 absmax, division and round-half-to-even in both frameworks).
* A decode step on the same int8 cache: logits at 1e-4, the f32 tolerance
  of ``tests/test_torch_model.py`` (the attend reads identical codes and
  scales; the matmuls sum in other orders).
* Steps on each package's own cache: the two frameworks' K/V differ by
  ~1e-7, so a code that sits on a rounding boundary (x / scale within
  ~1e-6 of k + 0.5) may land one step apart. Such a flip moves one K/V
  entry by one quantisation step (its head row's amax / 127), which moves
  a logit by ~1e-4 here. The logits are held at 1e-3 (the f32 model
  checks' tolerance in ``chip_smoke.py``), and the tests count the codes
  that differ instead of widening a bound: at most one code in a thousand
  written, each by one step.
* Greedy tokens of the engines: identical, as for the full-precision
  cache (``tests/test_torch_continuous.py``, ``tests/test_torch_paged.py``).
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
from repro.models.attention import QuantKVCache as JQuantKVCache
from repro.models.attention import _dequantize as j_dequantize
from repro.models.attention import _quantize as j_quantize
from repro.models.attention import attn_decode_stacked as j_attn_stacked
from repro.serving import DecodeEngine as JDecodeEngine
from repro.serving.continuous import ContinuousBatchingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.kernels import ops as kops
from repro_torch.models import (PagedKVCache, QuantKVCache, decode_step,
                                forward, init_cache, init_paged_cache,
                                reduced)
from repro_torch.models.attention import (_dequantize, _quantize,
                                          attn_decode_stacked)
from repro_torch.serving import ContinuousBatchingEngine, DecodeEngine
from repro_torch.weights import from_jax_params
from repro_torch.compat import cap_xdist_threads

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

TOL = dict(rtol=1e-4, atol=1e-4)
INT8_LOGIT_TOL = 1e-3
MAX_FLIP_FRACTION = 1e-3


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(j_reduced(j_get_config("qwen3-0.6b")),
                               kv_cache_dtype="int8")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b")),
                              kv_cache_dtype="int8")
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


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flips(got, want) -> tuple:
    """(codes that differ, the largest difference) of two int8 arrays."""
    d = np.abs(_np(got).astype(np.int32) - _np(want).astype(np.int32))
    return int((d > 0).sum()), int(d.max(initial=0))


# -------------------------------------------------------------- quantising
def _quant_input(case: str) -> np.ndarray:
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 11, 4, 64)).astype(np.float32)
    if case == "zeros":
        x[0, :5] = 0.0                       # amax 0: scale 1e-8, codes 0
        x[1, 2, 1] = 0.0
    elif case == "half_boundaries":
        # amax 127 gives scale 1 exactly: every k + 0.5 rounds to even
        x = np.zeros((2, 5, 2, 64), np.float32)
        x[..., 0] = 127.0
        x[..., 1:33] = np.arange(-15.5, 16.5, 1.0)
        x[..., 33] = -127.0
        x[..., 34:] = np.linspace(-126.5, 126.5, 30)
    elif case == "large":
        x *= 3e4
    elif case == "tiny":
        x *= 1e-30                           # scale floored at 1e-8
    return x


@pytest.mark.parametrize("case", ["normal", "zeros", "half_boundaries",
                                  "large", "tiny"])
def test_quantize_bitwise(case):
    x = _quant_input(case)
    jq, js = j_quantize(jnp.asarray(x))
    tq, ts = _quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if case == "half_boundaries":          # half to even, as jnp.round
        assert tq[0, 0, 0, 1:5].tolist() == [-16, -14, -14, -12]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_dequantize_bitwise_in_dtype(dtype):
    x = _quant_input("normal")
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = j_quantize(jx)
    tq, ts = _quantize(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = j_dequantize(jq, js, jx.dtype)
    td = _dequantize(tq, ts, tx.dtype)
    assert td.dtype == tx.dtype
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jd.astype(jnp.float32)))


# ------------------------------------------------------------------ caches
def test_int8_config_and_cache_layouts(model):
    _, _, cfg, _ = model
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        dataclasses.replace(cfg, kv_cache_dtype="fp8").validate()
    cfg.validate()
    kv = init_cache(cfg, batch=3, capacity=16, device="cpu")
    assert isinstance(kv, QuantKVCache) and kv.capacity == 16
    L, nkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    assert kv.k.shape == (L, 3, 16, nkv, hd) and kv.k.dtype == torch.int8
    assert kv.k_scale.shape == (L, 3, 16, nkv)
    assert kv.k_scale.dtype == torch.float32
    pc = init_paged_cache(cfg, batch=2, n_blocks=10, block_size=4, n_bt=6,
                          device="cpu")
    assert isinstance(pc, PagedKVCache) and pc.k.dtype == torch.int8
    assert pc.k_scale.shape == (L, 11, 4, nkv)      # + the trash block
    assert pc.v_scale.dtype == torch.float32
    full = init_paged_cache(dataclasses.replace(cfg, kv_cache_dtype="model"),
                            batch=2, n_blocks=10, block_size=4, n_bt=6,
                            device="cpu")
    assert full.k_scale is None and full.k.dtype == torch.float32
    # KV bytes per (position, head): hd codes + one f32 scale, against hd
    # elements of the model's dtype
    int8_bytes = pc.k.nbytes + pc.k_scale.nbytes
    assert int8_bytes / full.k.nbytes == pytest.approx((hd + 4) / (4 * hd))


@pytest.fixture(scope="module")
def prefilled(model):
    jcfg, jparams, cfg, params = model
    toks = np.random.default_rng(1).integers(1, 97, size=(2, 13))
    jo = j_forward(jcfg, jparams, jnp.asarray(toks, jnp.int32),
                   return_cache=True, cache_capacity=32)
    to = forward(cfg, params, torch.as_tensor(toks), return_cache=True,
                 cache_capacity=32)
    return toks, jo, to


def test_cache_from_prefill_int8_matches_reference(prefilled):
    _, jo, to = prefilled
    jc, tc = jo.cache["layers"], to.cache["layers"]
    assert isinstance(jc, JQuantKVCache) and isinstance(tc, QuantKVCache)
    np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits),
                               **TOL)
    written = tc.k[:, :, :13].numel()
    for name in ("k", "v"):
        n, worst = _flips(getattr(tc, name), getattr(jc, name))
        assert n <= MAX_FLIP_FRACTION * written and worst <= 1, (name, n)
        np.testing.assert_allclose(getattr(tc, name + "_scale").numpy(),
                                   np.asarray(getattr(jc, name + "_scale")),
                                   rtol=1e-6, atol=0)
    # past the prompt: the quantised zero padding, codes 0 and scales 1e-8
    assert not tc.k[:, :, 13:].any()
    np.testing.assert_array_equal(tc.k_scale[:, :, 13:].numpy(),
                                  np.asarray(jc.k_scale)[:, :, 13:])
    assert int(tc.length) == 13


def _to_port_cache(jc) -> QuantKVCache:
    """The JAX package's stacked int8 cache as the port's (its per-layer
    lengths, all equal, as the port's shared position)."""
    leaves = [torch.from_numpy(np.array(getattr(jc, f)))
              for f in ("k", "v", "k_scale", "v_scale")]
    return QuantKVCache(*leaves, length=torch.tensor(
        int(np.asarray(jc.length).reshape(-1)[0]), dtype=torch.int32))


def test_int8_decode_step_on_the_same_cache(model, prefilled):
    """One step on identical codes and scales: logits at the f32
    tolerance, and the new token's codes written alike but for rounding
    flips."""
    jcfg, jparams, cfg, params = model
    _, jo, _ = prefilled
    jc = jo.cache["layers"]
    tc = _to_port_cache(jc)
    tok = np.asarray(jnp.argmax(jo.logits[:, -1:], -1))
    jr = j_decode_step(jcfg, jparams, jnp.asarray(tok, jnp.int32),
                       jo.cache, static_layers=True)
    tr = decode_step(cfg, params, torch.as_tensor(tok), {"layers": tc})
    np.testing.assert_allclose(tr.logits.numpy(), np.asarray(jr.logits),
                               **TOL)
    jn = jr.cache["layers"]
    for name in ("k", "v"):
        got, want = getattr(tc, name)[:, :, 13], np.asarray(
            getattr(jn, name))[:, :, 13]
        n, worst = _flips(got, want)
        assert n <= max(1, MAX_FLIP_FRACTION * got.numel()) and worst <= 1
        np.testing.assert_allclose(
            getattr(tc, name + "_scale")[:, :, 13].numpy(),
            np.asarray(getattr(jn, name + "_scale"))[:, :, 13],
            rtol=1e-6, atol=0)
    assert int(tc.length) == 14


@pytest.mark.parametrize("force_ref", [False, True])
def test_int8_decode_steps_match_reference(model, prefilled, force_ref):
    """8 steps on each package's own int8 cache, teacher-forced on the JAX
    package's greedy tokens: logits within INT8_LOGIT_TOL and the codes
    written counted (module docstring)."""
    jcfg, jparams, cfg, params = model
    toks, jo, _ = prefilled
    to = forward(cfg, params, torch.as_tensor(toks), return_cache=True,
                 cache_capacity=32, force_ref=force_ref)
    jc, tc = jo.cache, to.cache
    jl = jo.logits[:, -1:]
    for _ in range(8):
        tok = np.asarray(jnp.argmax(jl, -1))
        jr = j_decode_step(jcfg, jparams, jnp.asarray(tok, jnp.int32), jc,
                           static_layers=True)
        tr = decode_step(cfg, params, torch.as_tensor(tok), tc,
                         force_ref=force_ref)
        jc, tc, jl = jr.cache, tr.cache, jr.logits
        np.testing.assert_allclose(tr.logits.numpy(), np.asarray(jl),
                                   rtol=0, atol=INT8_LOGIT_TOL)
        assert np.array_equal(tr.logits.argmax(-1).numpy(),
                              np.asarray(jnp.argmax(jl, -1)))
    k, jk = tc["layers"].k, jc["layers"].k
    n, worst = _flips(k[:, :, :21], np.asarray(jk)[:, :, :21])
    assert n <= MAX_FLIP_FRACTION * k[:, :, :21].numel() and worst <= 1


def test_per_row_int8_write_keeps_a_retired_row(model):
    """Per-row positions with a row past the capacity (a retired row
    riding a chunk): the JAX package drops its write, the port writes its
    old codes and scales back; the other rows' codes and scales and all
    rows' outputs agree with the JAX package's."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(9)
    L, B, C, nkv, hd = cfg.n_layers, 3, 8, cfg.n_kv_heads, cfg.hd
    q, s = _quantize(torch.from_numpy(
        rng.standard_normal((L, B, C, nkv, hd)).astype(np.float32)))
    q2, s2 = _quantize(torch.from_numpy(
        rng.standard_normal((L, B, C, nkv, hd)).astype(np.float32)))
    pos = np.array([3, 7, 9], np.int32)          # row 2 past C - 1
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    tkv = QuantKVCache(q.clone(), q2.clone(), s.clone(), s2.clone(),
                       length=torch.from_numpy(pos))
    jkv = JQuantKVCache(jnp.asarray(q.numpy()), jnp.asarray(q2.numpy()),
                        jnp.asarray(s.numpy()), jnp.asarray(s2.numpy()),
                        jnp.asarray(pos))
    p = {k: v[1] for k, v in params["blocks"]["attn"].items()}
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"]["attn"])
    ty = attn_decode_stacked(cfg, p, torch.from_numpy(x), tkv,
                             torch.from_numpy(pos), 1)
    jy, jkv = j_attn_stacked(jcfg, jp, jnp.asarray(x), jkv, jnp.asarray(pos),
                             1)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for name in ("k", "v", "k_scale", "v_scale"):
        got, want = getattr(tkv, name), np.asarray(getattr(jkv, name))
        if name.endswith("scale"):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
        else:
            n, worst = _flips(got, want)
            assert n <= 2 and worst <= 1
    assert torch.equal(tkv.k[1, 2], q[1, 2])       # the retired row kept
    assert torch.equal(tkv.k_scale[1, 2], s[1, 2])
    assert torch.equal(tkv.k[0], q[0])             # other layers untouched


# ----------------------------------------------------------------- engines
def drain(eng, reqs, use_step=False, chunk=None):
    pending = list(reqs)
    done = {}
    while pending or eng.n_active:
        if pending:
            flags = eng.admit_many(pending)
            pending = [r for r, ok in zip(pending, flags) if not ok]
        for s in (eng.step() if use_step else eng.step_chunk(chunk)):
            done[s.rid] = [int(t) for t in s.tokens]
    return done


SLOT = dict(max_slots=4, capacity=64, chunk=5)
PAGED = dict(max_slots=4, capacity=64, chunk=5, paged=True, block_size=8)


@pytest.fixture(scope="module")
def jax_drains(model, requests):
    """The JAX package's int8 drains, slot and paged (its own tests pin
    them equal: ``tests/test_paged.py::test_paged_int8_matches_slot_int8``)."""
    jcfg, jparams, _, _ = model
    return {name: drain(JEngine(jcfg, jparams, **kw), requests)
            for name, kw in (("slot", SLOT), ("paged", PAGED))}


@pytest.mark.parametrize("mode", ["slot", "paged"])
def test_continuous_int8_matches_reference(model, requests, jax_drains,
                                           mode):
    _, _, cfg, params = model
    eng = ContinuousBatchingEngine(cfg, params,
                                   **(PAGED if mode == "paged" else SLOT))
    assert drain(eng, requests) == jax_drains[mode]
    assert eng.n_active == 0
    if mode == "paged":
        assert eng.check_block_invariants()
        assert eng.allocator.n_free == eng.allocator.n_blocks


@pytest.mark.parametrize("mode", ["slot", "paged"])
def test_continuous_int8_step_equals_step_chunk(model, requests, mode):
    """The per-token ``step`` and the static-buffer chunk path (chunks 5
    and 13) give the same tokens."""
    _, _, cfg, params = model
    kw = PAGED if mode == "paged" else SLOT
    runs = [drain(ContinuousBatchingEngine(cfg, params, **kw), requests[:6],
                  use_step, chunk)
            for use_step, chunk in ((True, None), (False, None),
                                    (False, 13))]
    assert all(r == runs[0] for r in runs[1:])


def test_paged_int8_matches_slot_int8(model, requests):
    """Reference ``tests/test_paged.py::test_paged_int8_matches_slot_int8``
    on the port, and the pool really is int8 with f32 scales."""
    _, _, cfg, params = model
    slot = ContinuousBatchingEngine(cfg, params, **SLOT)
    paged = ContinuousBatchingEngine(cfg, params, **PAGED)
    assert drain(paged, requests) == drain(slot, requests)
    pc = paged.cache["layers"]
    assert pc.k.dtype == torch.int8 and pc.k_scale is not None
    assert pc.k_scale.dtype == torch.float32
    assert isinstance(slot.cache["layers"], QuantKVCache)


def test_int8_paged_decode_never_runs_the_paged_kernel(model, requests,
                                                       monkeypatch):
    """An int8 pool attends through the gather and the slot decode
    kernel's wrapper, never the paged kernel's."""
    _, _, cfg, params = model
    calls = {"decode": 0}
    orig = kops.decode_attention

    def paged(*a, **k):
        raise AssertionError("paged_decode_attention on an int8 pool")

    def slot(*a, **k):
        calls["decode"] += 1
        return orig(*a, **k)
    monkeypatch.setattr(kops, "paged_decode_attention", paged)
    monkeypatch.setattr(kops, "decode_attention", slot)
    eng = ContinuousBatchingEngine(cfg, params, **PAGED)
    drain(eng, requests[:3])
    assert calls["decode"] > 0 and calls["decode"] % cfg.n_layers == 0


@pytest.fixture(scope="module")
def engine_prompts():
    rng = np.random.default_rng(4)
    return [rng.integers(1, 97, size=(3, 9)).astype(np.int32),
            rng.integers(1, 97, size=(3, 9)).astype(np.int32)]


def test_decode_engine_int8_matches_reference(model, engine_prompts):
    """``DecodeEngine`` on an int8 cache: the same greedy tokens as the JAX
    engine's, on the static-buffer chunk path and on the per-token loop.
    The second call reuses the first call's static buffers, its prefill's
    codes and scales copied in."""
    jcfg, jparams, cfg, params = model
    budgets = [7, 0, 17]
    jeng = JDecodeEngine(jcfg, jparams, cache_capacity=64, chunk=4)
    eng = DecodeEngine(cfg, params, cache_capacity=64, chunk=4)
    for prompts in engine_prompts:
        want = jeng.generate(prompts, budgets, max_extra_tokens=3)
        got = eng.generate(prompts, budgets, max_extra_tokens=3)
        loop = eng.generate(prompts, budgets, max_extra_tokens=3,
                            use_scan=False)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(loop["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["n_reasoning"],
                                      np.minimum(budgets, got["n_generated"]))
    cache = eng._static[(3, 4)]["cache"]["layers"]
    assert isinstance(cache, QuantKVCache)
    assert len(eng._static) == 1


def test_decode_engine_int8_static_buffers_are_refilled(model,
                                                        engine_prompts):
    """A fresh engine per prompt set gives what one engine gives for the
    second set: the scales, not only the codes, reach the captured step's
    buffers."""
    _, _, cfg, params = model
    eng = DecodeEngine(cfg, params, cache_capacity=64, chunk=4)
    eng.generate(engine_prompts[0], [5, 5, 5], max_extra_tokens=2)
    st = eng._static[(3, 4)]["cache"]["layers"]
    scale_ptr = st.k_scale.data_ptr()
    second = eng.generate(engine_prompts[1], [5, 5, 5], max_extra_tokens=2)
    fresh = DecodeEngine(cfg, params, cache_capacity=64, chunk=4).generate(
        engine_prompts[1], [5, 5, 5], max_extra_tokens=2)
    np.testing.assert_array_equal(second["tokens"], fresh["tokens"])
    assert eng._static[(3, 4)]["cache"]["layers"].k_scale.data_ptr() == \
        scale_ptr
    logits, cache = eng.prefill(engine_prompts[1])
    np.testing.assert_array_equal(
        st.k_scale[:, :, :9].numpy(), cache["layers"].k_scale[:, :, :9]
        .numpy())
