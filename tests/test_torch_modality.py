"""The VLM and audio families, ``llava-next-mistral-7b`` and
``musicgen-medium``, against ``repro``'s.

Both are the dense decoder behind a stubbed modality frontend that
supplies ``n_prefix_embeds`` embeddings at ``d_model`` (image patches,
conditioning frames). Both packages run the reduced configs (2 layers,
f32, P = 8 prefix rows) on the JAX package's parameters
(``from_jax_params``), with prefix embeddings drawn from a seeded numpy
generator at 0.1 x normal, as ``tests/test_configs_smoke.py`` draws them.
Tolerances: configs exactly; logits over all P + S positions at
rtol = atol = 1e-4 (sums in other orders through two layers, as
``tests/test_torch_model.py``); a decode step after a prefix prefill
against a fresh forward over the extended sequence at 2e-4
(``test_configs_smoke.py``'s bound); greedy tokens of both engines
exactly. The continuous engine and the server carry no prefix in either
package, so there the two ids serve text-only.
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
from repro.models import init_decode_cache as j_init_decode_cache
from repro.models import init_params as j_init_params
from repro.models import reduced as j_reduced
from repro.models.transformer import count_params
from repro.serving import DecodeEngine as JDecodeEngine
from repro.serving.continuous import ContinuousBatchingEngine as JEngine
from repro_torch.compat import cap_xdist_threads
from repro_torch.configs import all_configs, get_config
from repro_torch.models import (decode_step, forward, init_decode_cache,
                                reduced)
from repro_torch.serving import ContinuousBatchingEngine, DecodeEngine
from repro_torch.weights import from_jax_params

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["llava-next-mistral-7b", "musicgen-medium"]
BANDS = {"musicgen-medium": (1.0, 2.0),          # test_configs_smoke.py
         "llava-next-mistral-7b": (6.5, 8.0)}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = j_reduced(j_get_config(request.param))
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config(request.param))
    params = from_jax_params(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _prefix(cfg, B: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.1 * rng.normal(size=(B, cfg.n_prefix_embeds, cfg.d_model))) \
        .astype(np.float32)


def _tokens(cfg, B: int, S: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cut", [False, True], ids=["full", "reduced"])
def test_configs_match_reference(arch, cut):
    """Every field the two configs share is equal, full and reduced; the
    sub-configs a dense backbone never reads are None in the port."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    if cut:
        jcfg, cfg = j_reduced(jcfg), reduced(cfg)
    for f in dataclasses.fields(cfg):
        want = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(want):
            assert getattr(cfg, f.name) is None, f.name
            continue
        assert getattr(cfg, f.name) == want, f.name
    assert cfg.block_kinds == jcfg.block_kinds == ("attn",) * cfg.n_layers
    assert cfg.hd == jcfg.hd and cfg.padded_vocab == jcfg.padded_vocab
    assert cfg.source == jcfg.source
    cfg.validate()
    cfg.validate(paged=True)
    if cut:
        assert cfg.n_prefix_embeds == 8 and not cfg.remat


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_in_band(arch):
    cfg = get_config(arch)
    lo, hi = BANDS[arch]
    assert lo <= cfg.param_count() / 1e9 <= hi
    jcfg = j_get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    # count_params counts the parameter tree, norms included
    assert lo <= count_params(jcfg) / 1e9 <= hi


def test_all_configs_and_every_family_validates():
    configs = all_configs()
    assert {c.family for c in configs.values()} \
        == {"dense", "moe", "ssm", "hybrid", "vlm", "audio"}
    for arch, cfg in configs.items():
        assert cfg.arch_id == arch
        cfg.validate()


@pytest.mark.parametrize("arch", ARCHS)
def test_validate_needs_prefix_slots(arch):
    with pytest.raises(ValueError, match="prefix slots"):
        dataclasses.replace(get_config(arch), n_prefix_embeds=0).validate()


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("force_ref", [False, True],
                         ids=["kernels", "reference"])
def test_forward_with_prefix_matches_reference(model, force_ref):
    jcfg, jparams, cfg, params = model
    pe, toks = _prefix(cfg, 2), _tokens(cfg, 2, 16)
    want = j_forward(jcfg, jparams, jnp.asarray(toks),
                     prefix_embeds=jnp.asarray(pe)).logits
    got = forward(cfg, params, torch.from_numpy(toks),
                  prefix_embeds=torch.from_numpy(pe),
                  force_ref=force_ref).logits
    assert tuple(got.shape) == (2, cfg.n_prefix_embeds + 16,
                                cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_prefix_changes_the_text_logits(model):
    """The prefix is attended to: the text positions' logits move when it
    does (positions run over all P + S rows)."""
    _, _, cfg, params = model
    toks = torch.from_numpy(_tokens(cfg, 1, 9))
    a = forward(cfg, params, toks,
                prefix_embeds=torch.from_numpy(_prefix(cfg, 1, 0))).logits
    b = forward(cfg, params, toks,
                prefix_embeds=torch.from_numpy(_prefix(cfg, 1, 7))).logits
    assert not torch.allclose(a[:, -9:], b[:, -9:], atol=1e-3)


def test_decode_after_prefix_prefill(model):
    """``test_smoke_forward_and_decode`` on the port: a decode step that
    continues a prefix prefill's cache agrees with a fresh forward over
    the extended sequence (2e-4) and with the JAX package's step (1e-4)."""
    jcfg, jparams, cfg, params = model
    B, S = 2, 16
    pe, toks = _prefix(cfg, B), _tokens(cfg, B, S)
    total = S + cfg.n_prefix_embeds
    out = forward(cfg, params, torch.from_numpy(toks),
                  prefix_embeds=torch.from_numpy(pe), return_cache=True,
                  cache_capacity=total + 8)
    assert tuple(out.logits.shape) == (B, total, cfg.padded_vocab)
    assert int(out.cache["layers"].length) == total
    tok = torch.argmax(out.logits[:, -1:, :], -1)
    dec = decode_step(cfg, params, tok, out.cache)
    assert tuple(dec.logits.shape) == (B, 1, cfg.padded_vocab)
    assert np.isfinite(_np(dec.logits)).all()
    out2 = forward(cfg, params, torch.cat([torch.from_numpy(toks).long(),
                                           tok], 1),
                   prefix_embeds=torch.from_numpy(pe))
    np.testing.assert_allclose(_np(dec.logits[:, 0]),
                               _np(out2.logits[:, -1]), atol=2e-4)
    jout = j_forward(jcfg, jparams, jnp.asarray(toks),
                     prefix_embeds=jnp.asarray(pe), return_cache=True,
                     cache_capacity=total + 8)
    jdec = j_decode_step(jcfg, jparams, jnp.asarray(tok.numpy(), jnp.int32),
                         jout.cache)
    np.testing.assert_allclose(_np(dec.logits), _np(jdec.logits), **TOL)


def test_decode_from_empty_cache(model):
    """``test_decode_from_empty_cache`` on the port, step for step against
    the JAX package's."""
    jcfg, jparams, cfg, params = model
    cache = init_decode_cache(cfg, 2, 32, device="cpu")
    jcache = j_init_decode_cache(jcfg, 2, capacity=32)
    tok = torch.zeros(2, 1, dtype=torch.long)
    jtok = jnp.zeros((2, 1), jnp.int32)
    for _ in range(3):
        out = decode_step(cfg, params, tok, cache)
        jout = j_decode_step(jcfg, jparams, jtok, jcache)
        cache, jcache = out.cache, jout.cache
        assert np.isfinite(_np(out.logits)).all()
        np.testing.assert_allclose(_np(out.logits), _np(jout.logits), **TOL)
        tok = torch.argmax(out.logits, -1)
        jtok = jnp.argmax(jout.logits, -1).astype(jnp.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


# ---------------------------------------------------------------- engines
BUDGETS = [5, 0, 11]
EXTRA = 3


@pytest.fixture(scope="module")
def jax_tokens(model):
    jcfg, jparams, cfg, _ = model
    pe, prompts = _prefix(cfg, 3, 2), _tokens(cfg, 3, 10, 3)
    out = JDecodeEngine(jcfg, jparams, cache_capacity=64, chunk=4).generate(
        prompts, BUDGETS, max_extra_tokens=EXTRA, prefix_embeds=pe)
    return pe, prompts, out


@pytest.mark.parametrize("chunk", [None, 1, 4, 16],
                         ids=["loop", "chunk1", "chunk4", "chunk16"])
def test_engine_with_prefix_matches_reference(model, jax_tokens, chunk):
    """Greedy tokens of ``DecodeEngine.generate(prefix_embeds=...)``: the
    per-token loop and the static-buffer chunk path at chunks 1, 4, 16,
    each equal to the JAX engine's."""
    _, _, cfg, params = model
    pe, prompts, want = jax_tokens
    eng = DecodeEngine(cfg, params, cache_capacity=64, chunk=chunk or 4)
    got = eng.generate(prompts, BUDGETS, max_extra_tokens=EXTRA,
                       prefix_embeds=pe, use_scan=chunk is not None)
    for k in ("tokens", "n_generated", "n_reasoning"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert list(got["n_generated"]) == [b + EXTRA for b in BUDGETS]


def test_one_capture_serves_prefix_and_text(model):
    """The static-buffer step adopted after a prefix prefill serves a
    text-only call and another prefix: only the cache's length moves."""
    jcfg, jparams, cfg, params = model
    eng = DecodeEngine(cfg, params, cache_capacity=64, chunk=4)
    prompts = _tokens(cfg, 3, 10, 3)
    eng.generate(prompts, BUDGETS, max_extra_tokens=EXTRA,
                 prefix_embeds=_prefix(cfg, 3, 2))
    st = eng._static[(3, 4)]["cache"]["layers"]
    text = eng.generate(prompts, [7, 2, 4], max_extra_tokens=1)
    assert eng._static[(3, 4)]["cache"]["layers"] is st
    other = eng.generate(prompts, [4, 4, 4], max_extra_tokens=0,
                         prefix_embeds=_prefix(cfg, 3, 9))
    jeng = JDecodeEngine(jcfg, jparams, cache_capacity=64, chunk=4)
    np.testing.assert_array_equal(text["tokens"], np.asarray(jeng.generate(
        prompts, [7, 2, 4], max_extra_tokens=1)["tokens"]))
    np.testing.assert_array_equal(other["tokens"], np.asarray(jeng.generate(
        prompts, [4, 4, 4], max_extra_tokens=0,
        prefix_embeds=_prefix(cfg, 3, 9))["tokens"]))


def test_small_cache_capacity_raises(model):
    _, _, cfg, params = model
    eng = DecodeEngine(cfg, params, cache_capacity=20)
    prompts = _tokens(cfg, 1, 10)
    with pytest.raises(ValueError, match=r"prefix 8 \+ prompt 10 \+ 5 "
                       r"generated tokens exceed cache_capacity 20"):
        eng.generate(prompts, [3], max_extra_tokens=2,
                     prefix_embeds=_prefix(cfg, 1))
    out = eng.generate(prompts, [1], max_extra_tokens=1,
                       prefix_embeds=_prefix(cfg, 1))      # 8 + 10 + 2
    assert list(out["n_generated"]) == [2]


# prompt lengths and budgets of a small drain: groups of equal length,
# a slot refilled
LENGTHS = (12, 5, 12, 9, 5)
DRAIN_BUDGETS = (6, 13, 2, 9, 4)
REQUESTS = [(i, (np.arange(n) * (i + 3)) % 89 + 2, b, 2)
            for i, (n, b) in enumerate(zip(LENGTHS, DRAIN_BUDGETS))]


def _drain(eng):
    pending, done = list(REQUESTS), {}
    while pending or eng.n_active:
        if pending:
            flags = eng.admit_many(pending)
            pending = [r for r, ok in zip(pending, flags) if not ok]
        for s in eng.step_chunk():
            done[s.rid] = s.tokens
    return done


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_continuous_engine_text_only_matches_reference(model, paged):
    """The slot and the paged continuous engines, text-only as in the JAX
    package: every request's greedy tokens equal the JAX engine's."""
    jcfg, jparams, cfg, params = model
    kw = dict(max_slots=3, capacity=64, chunk=4)
    if paged:
        kw.update(paged=True, block_size=8)
    want = _drain(JEngine(jcfg, jparams, **kw))
    got = _drain(ContinuousBatchingEngine(cfg, params, **kw))
    assert got == want
    assert {rid: len(t) for rid, t in got.items()} \
        == {rid: b + x for rid, _, b, x in REQUESTS}
