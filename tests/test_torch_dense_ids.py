"""The three remaining dense ids, ``olmo-1b`` (LayerNorm without
parameters), ``stablelm-3b`` (LayerNorm) and ``starcoder2-3b`` (LayerNorm,
GELU MLP, a sliding window of 4096 and so a ring-buffer decode cache),
against ``repro``'s.

Both packages run the reduced configs (2 layers, d_model 256, f32; the
window cut to 64) on the JAX package's parameters (``from_jax_params``).
Tolerances: the configs and parameter trees exactly; the ring's validity
mask bitwise; a norm or the GELU MLP alone at 1e-6 (one f32 layer, the
same operations in another library); prefill logits and 8 decode steps
at rtol = atol = 1e-4 (as ``tests/test_torch_model.py``: sums in other
orders through two layers); greedy tokens of ``DecodeEngine`` exactly, on
the full-precision and the int8 cache, with an 80-token prompt and 40
decode steps so that the prompt overflows the 64-slot ring and decode
wraps it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attention
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import layers as j_layers
from repro.models import reduced as j_reduced
from repro.serving import DecodeEngine as JDecodeEngine
from repro_torch.configs import NOT_YET_PORTED, get_config
from repro_torch.launch import serve
from repro_torch.models import (decode_step, forward, init_paged_cache,
                                init_params, layers, reduced)
from repro_torch.models.attention import _decode_valid
from repro_torch.serving import DecodeEngine
from repro_torch.weights import from_jax_params
from repro_torch.compat import cap_xdist_threads

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=1e-6, atol=1e-6)
ARCHS = ["olmo-1b", "stablelm-3b", "starcoder2-3b"]


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


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """Every field of the port's config equals the JAX config's, full and
    reduced (the ssm / rwkv sub-configs, which a dense model never reads,
    are None in the port); the ids are ported."""
    assert arch not in NOT_YET_PORTED
    for cfg, jcfg in ((get_config(arch), j_get_config(arch)),
                      (reduced(get_config(arch)),
                       j_reduced(j_get_config(arch)))):
        for f in dataclasses.fields(cfg):
            got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
            if dataclasses.is_dataclass(want):
                assert got is None, f.name
            else:
                assert got == want, f.name
        assert cfg.hd == jcfg.hd and cfg.padded_vocab == jcfg.padded_vocab
        cfg.validate()


def test_param_trees_match_reference(model):
    """Same keys, shapes and dtypes as the JAX tree, from both
    ``init_params`` and ``from_jax_params``: LayerNorm's scale and bias,
    OLMo's norms empty, starcoder2's MLP without a gate."""
    jcfg, _, cfg, _ = model
    jtree = jax.device_get(j_init_params(jcfg, jax.random.PRNGKey(1)))

    def layout(tree):
        return {jax.tree_util.keystr(path): (tuple(leaf.shape),
                                             str(leaf.dtype).split(".")[-1])
                for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    want = layout(jtree)
    for tree in (init_params(cfg, seed=0, device="cpu"),
                 from_jax_params(jtree, device="cpu")):
        assert layout(tree) == want
        blocks = tree["blocks"]
        assert set(blocks["ln1"]) == {"rmsnorm": {"scale"},
                                      "layernorm": {"scale", "bias"},
                                      "nonparametric_ln": set()}[cfg.norm]
        assert ("gate" in blocks["mlp"]) == cfg.gated_mlp


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm",
                                  "nonparametric_ln"])
def test_apply_norm_matches_reference(norm):
    cfg = dataclasses.replace(reduced(get_config("stablelm-3b")), norm=norm)
    jcfg = dataclasses.replace(j_reduced(j_get_config("stablelm-3b")),
                               norm=norm)
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((2, 7, cfg.d_model)) + 0.5) \
        .astype(np.float32)
    p = {k: rng.standard_normal(cfg.d_model).astype(np.float32)
         for k in j_layers.init_norm(jcfg, None)}
    want = j_layers.apply_norm(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x))
    got = layers.apply_norm(cfg, {k: torch.from_numpy(v)
                                  for k, v in p.items()},
                            torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


@pytest.mark.parametrize("force_ref", [False, True])
def test_gelu_mlp_matches_reference(force_ref):
    """The GELU MLP (up, tanh-approximated GELU in f32, down), which no
    kernel takes, on the kernel path and the reference path alike."""
    cfg = reduced(get_config("starcoder2-3b"))
    jcfg = j_reduced(j_get_config("starcoder2-3b"))
    jp = jax.device_get(j_layers.init_mlp(jcfg, jax.random.PRNGKey(2)))
    assert set(jp) == {"up", "down"}
    x = np.random.default_rng(1).standard_normal((2, 5, cfg.d_model)) \
        .astype(np.float32)
    want = j_layers.apply_mlp(jcfg, jp, jnp.asarray(x))
    got = layers.apply_mlp(cfg, from_jax_params(jp, device="cpu"),
                           torch.from_numpy(x), force_ref=force_ref)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_ring_valid_mask_matches_reference(per_row):
    """The ring's mask of valid slots, rebuilt from each slot's global
    position, bitwise the JAX package's, before and after the ring wraps
    and with a ring shorter than the window."""
    for C, window in ((64, 64), (16, 24)):
        cfg = dataclasses.replace(j_reduced(j_get_config("starcoder2-3b")),
                                  sliding_window=window)
        for p0 in (0, 5, C - 1, C, C + 7, 3 * C + 2):
            pos = np.array([p0, p0 + 1, max(p0 - 3, 0)] if per_row else p0,
                           np.int32)
            slot = pos % C
            want = j_attention._decode_valid(
                cfg, jnp.asarray(pos), jnp.asarray(slot), 3, C,
                per_row)[:, 0]
            got = _decode_valid(torch.from_numpy(pos), C, "cpu", window)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_pool_refuses_a_window():
    cfg = reduced(get_config("starcoder2-3b"))
    with pytest.raises(ValueError, match="paged KV"):
        init_paged_cache(cfg, 2, 8, 16, 4, "cpu")
    with pytest.raises(ValueError, match="paged KV"):
        cfg.validate(paged=True)


# ------------------------------------------------------------------- models
@pytest.mark.parametrize("force_ref", [False, True])
def test_forward_logits_match_reference(model, force_ref):
    """An 80-token prompt (past starcoder2's reduced window of 64) through
    the kernel path (flash with the window, plain on the CPU) and the
    reference path."""
    jcfg, jparams, cfg, params = model
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 80))
    want = j_forward(jcfg, jparams, jnp.asarray(tokens, jnp.int32)).logits
    got = forward(cfg, params, torch.from_numpy(tokens),
                  force_ref=force_ref).logits
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_prefill_then_decode_matches_reference(model):
    """Prefill of 80 tokens into a cache of 128 (starcoder2: a ring of 64
    holding the last 64 at slots p % 64), then 8 decode steps against the
    JAX ``decode_step(static_layers=True)``: logits every step, the cache
    after the last."""
    jcfg, jparams, cfg, params = model
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 80))
    jout = j_forward(jcfg, jparams, jnp.asarray(tokens, jnp.int32),
                     return_cache=True, cache_capacity=128)
    out = forward(cfg, params, torch.from_numpy(tokens), return_cache=True,
                  cache_capacity=128)
    jcache, cache = jout.cache, out.cache
    assert cache["layers"].capacity == jcache["layers"].k.shape[2] \
        == (64 if cfg.sliding_window else 128)
    np.testing.assert_allclose(_np(cache["layers"].k),
                               _np(jcache["layers"].k), **TOL)
    step = jax.jit(lambda p, t, c: j_decode_step(jcfg, p, t, c,
                                                 static_layers=True))
    for i in range(8):
        tok = np.array([[5 + i], [7 * i]], np.int32)
        jres = step(jparams, jnp.asarray(tok), jcache)
        res = decode_step(cfg, params, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(_np(res.logits), _np(jres.logits), **TOL)
        jcache, cache = jres.cache, res.cache
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(getattr(cache["layers"], name)),
                                   _np(getattr(jcache["layers"], name)),
                                   **TOL)
    assert int(cache["layers"].length) == 88


@pytest.fixture(scope="module")
def starcoder2():
    jcfg = j_reduced(j_get_config("starcoder2-3b"))
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, reduced(get_config("starcoder2-3b")), \
        from_jax_params(jax.device_get(jparams), device="cpu")


@pytest.mark.parametrize("kv_cache_dtype", ["model", "int8"])
def test_windowed_engine_matches_reference(starcoder2, kv_cache_dtype):
    """``DecodeEngine`` on reduced starcoder2 (ring of 64): two 80-token
    prompts, budgets 39 and 30 plus 2 answer tokens, so the longer row
    takes 40 decode steps past the prompt's wrap of the ring; greedy
    tokens equal to the JAX engine's on the chunk path and the per-token
    loop, on both caches."""
    jcfg, jparams, cfg, params = starcoder2
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv_cache_dtype)
    cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_cache_dtype)
    prompts = (np.arange(160).reshape(2, 80) * 7) % 89 + 2
    budgets = [39, 30]
    want = JDecodeEngine(jcfg, jparams, cache_capacity=128,
                         chunk=16).generate(prompts, budgets,
                                            max_extra_tokens=2)
    eng = DecodeEngine(cfg, params, cache_capacity=128, chunk=16)
    for use_scan in (True, False):
        got = eng.generate(prompts, budgets, max_extra_tokens=2,
                           use_scan=use_scan)
        for key in ("tokens", "n_generated", "n_reasoning"):
            np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["n_generated"], [41, 32])


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_id(arch, capsys):
    rep = serve.main(["--reduced", "--device", "cpu", "--real-engine",
                      "--queries", "2", "--arch", arch])
    assert rep["n"] == 2 and rep["tokens_generated"] > 0
    assert '"allocator_resolves": 1' in capsys.readouterr().out
