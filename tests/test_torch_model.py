"""Model parity: the port's dense decoder against ``repro.models`` on the
JAX package's own parameters (carried across with ``from_jax_params``).

Logits are compared at rtol = atol = 1e-4 in f32: the two packages sum the
same products in other orders over two layers of d_model 256 reductions.
Greedy decoding must agree token for token.
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
from repro.serving import DecodeEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models import decode_step, forward, init_params, reduced
from repro_torch.serving import DecodeEngine
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


def test_reduced_config_matches_reference(model):
    jcfg, _, cfg, _ = model
    for f in dataclasses.fields(cfg):
        if f.name != "family" and hasattr(jcfg, f.name):
            got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
            if dataclasses.is_dataclass(want):   # moe / ssm / rwkv configs:
                assert got is None, f.name       # a dense model reads none
                continue
            assert got == want, f.name
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert cfg.hd == jcfg.hd


def test_unported_arch_raises():
    """Every id of the JAX registry is ported; an id outside it raises."""
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llava-next-mistral-70b")


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("force_ref", [False, True])
def test_forward_logits_match_reference(model, use_kernels, force_ref):
    """JAX with and without its Pallas kernels (interpret mode; S = 32
    passes their % 16 gates) against the port's kernel path (plain
    versions on the CPU) and its reference path."""
    jcfg, jparams, cfg, params = model
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32))
    jcfg = dataclasses.replace(jcfg, use_kernels=use_kernels)
    want = j_forward(jcfg, jparams, jnp.asarray(tokens, jnp.int32)).logits
    got = forward(cfg, params, torch.from_numpy(tokens),
                  force_ref=force_ref).logits
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_step_logits_match_reference(model):
    """Prefill of a ragged length (S = 13) then three decode steps."""
    jcfg, jparams, cfg, params = model
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 13))
    jout = j_forward(jcfg, jparams, jnp.asarray(tokens, jnp.int32),
                     return_cache=True, cache_capacity=32)
    out = forward(cfg, params, torch.from_numpy(tokens), return_cache=True,
                  cache_capacity=32)
    jcache, cache = jout.cache, out.cache
    for step in range(3):
        tok = np.array([[5 + step], [7 * step]], np.int32)
        jres = j_decode_step(jcfg, jparams, jnp.asarray(tok), jcache,
                             static_layers=True)
        res = decode_step(cfg, params, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(res.logits.numpy(),
                                   np.asarray(jres.logits), **TOL)
        jcache, cache = jres.cache, res.cache
    assert cache["layers"].length == 13 + 3


@pytest.mark.parametrize("use_scan", [False, True])
def test_generate_matches_reference_token_for_token(model, use_scan):
    """Ragged budgets including 0, crossing chunk boundaries (chunk = 4),
    as in tests/test_engine_fast_path.py."""
    jcfg, jparams, cfg, params = model
    prompts = np.ones((4, 8), dtype=np.int32)
    budgets = [5, 9, 0, 3]
    want = JEngine(jcfg, jparams, cache_capacity=64, chunk=4).generate(
        prompts, budgets, max_extra_tokens=2, use_scan=use_scan)
    got = DecodeEngine(cfg, params, cache_capacity=64, chunk=4).generate(
        prompts, budgets, max_extra_tokens=2, use_scan=use_scan)
    for key in ("tokens", "n_generated", "n_reasoning"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["n_reasoning"], budgets)


def test_port_init_params_shapes_and_scale():
    cfg = reduced(get_config("qwen3-0.6b"))
    p = init_params(cfg, seed=0, device="cpu")
    assert p["blocks"]["attn"]["wq"].shape == (2, 256, 4 * 64)
    assert p["blocks"]["mlp"]["down"].shape == (2, cfg.d_ff, 256)
    assert p["embed"]["tok"].shape == (cfg.padded_vocab, 256)
    std = float(p["blocks"]["mlp"]["up"].std())
    assert std == pytest.approx((2.0 / 256) ** 0.5 / 2, rel=0.05)
    again = init_params(cfg, seed=0, device="cpu")
    assert torch.equal(p["embed"]["tok"], again["embed"]["tok"])


def test_generate_eos_early_stop_matches_reference(model):
    """EOS after the reasoning phase stops a row early on both paths and in
    both packages, at the same position."""
    jcfg, jparams, cfg, params = model
    prompts = np.ones((2, 8), dtype=np.int32)
    budgets = [4, 6]
    eng = DecodeEngine(cfg, params, cache_capacity=64, chunk=4)
    eos = int(eng.generate(prompts, budgets, max_extra_tokens=6)
              ["tokens"][0, 4])                  # row 0's first answer token
    want = JEngine(jcfg, jparams, cache_capacity=64, chunk=4).generate(
        prompts, budgets, max_extra_tokens=6, eos_token=eos)
    for use_scan in (False, True):
        got = eng.generate(prompts, budgets, max_extra_tokens=6,
                           eos_token=eos, use_scan=use_scan)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["n_generated"], want["n_generated"])
    assert got["n_generated"][0] == 5 and got["n_reasoning"][0] == 4


def test_sampling_seeded_and_reproducible(model):
    """temperature > 0 draws from a generator seeded by ``seed``: the same
    seed gives the same tokens, on the chunked and the per-token path."""
    _, _, cfg, params = model
    eng = DecodeEngine(cfg, params, cache_capacity=64, chunk=4,
                       temperature=0.8)
    prompts = np.ones((2, 6), dtype=np.int32)
    a = eng.generate(prompts, [5, 7], max_extra_tokens=0, seed=3)
    b = eng.generate(prompts, [5, 7], max_extra_tokens=0, seed=3)
    loop = eng.generate(prompts, [5, 7], max_extra_tokens=0, seed=3,
                        use_scan=False)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["tokens"], loop["tokens"])
    np.testing.assert_array_equal(a["n_reasoning"], [5, 7])
