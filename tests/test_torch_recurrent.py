"""The recurrent and hybrid slice: the port's RWKV6 and Mamba2 + shared
attention models against ``repro.models`` on the JAX package's own
parameters (carried across with ``from_jax_params``), block by block, as
whole models, through ``DecodeEngine`` and through ``LLMServer``.

Configs: reduced ``rwkv6-1.6b`` (2 layers, d_model 256, head_dim 32) and
the hybrid ``zamba2-7b`` reduced to 5 layers with ``attn_every=2``, built
the same way in both packages, so the shared block runs twice (g = 2) and
one Mamba2 layer remains (the default reduction keeps ``attn_every=6``
with 2 layers and never reaches the shared block). Outputs, states and
logits are compared at rtol = atol = 1e-4 in f32 (the port's scans and
the JAX package's jnp chunked scans sum in other orders); greedy tokens
and the server's reports must agree exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import queueing_sim as jqs
from repro import serving as jserving
from repro.configs import get_config as j_get_config
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_decode_cache as j_init_decode_cache
from repro.models import init_params as j_init_params
from repro.models import mamba2 as j_mamba2
from repro.models import reduced as j_reduced
from repro.models import rwkv6 as j_rwkv6
from repro_torch import core as tcore
from repro_torch import queueing_sim as tqs
from repro_torch import serving as tserving
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import (decode_step, forward, init_decode_cache,
                                init_params, mamba2, reduced, rwkv6)
from repro_torch.weights import from_jax_params
from repro_torch.compat import cap_xdist_threads

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["rwkv6-1.6b", "zamba2-7b"]


def _configs(arch: str):
    """(JAX config, port config): reduced rwkv6, or the hybrid reduced to
    5 layers with the shared block every 2 (g = 2, one remaining layer)."""
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
def jax_step(model):
    """The JAX ``decode_step(static_layers=True)``, jitted once per model."""
    return jax.jit(functools.partial(j_decode_step, model[0],
                                     static_layers=True))


@pytest.fixture(scope="module")
def engines(model):
    """One JAX and one port ``DecodeEngine`` per model (capacity 64, chunk
    4), shared so the JAX engine compiles once."""
    jcfg, jparams, cfg, params = model
    return (jserving.DecodeEngine(jcfg, jparams, cache_capacity=64, chunk=4),
            tserving.DecodeEngine(cfg, params, cache_capacity=64, chunk=4))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _fields_equal(a, b):
    """A sub-config the port leaves None is one its family never reads
    (the JAX config carries its default there); ``SSMConfig.chunk``, the
    reference math's chunk length, is compared with the rest."""
    if dataclasses.is_dataclass(b):
        return a is None or dataclasses.asdict(a) == dataclasses.asdict(b)
    return a == b


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for jcfg, cfg in ((j_get_config(arch), get_config(arch)),
                      _configs(arch)):
        for f in dataclasses.fields(cfg):
            assert _fields_equal(getattr(cfg, f.name),
                                 getattr(jcfg, f.name)), f.name
        assert cfg.block_kinds == jcfg.block_kinds
        assert (cfg.rwkv is not None) == (cfg.backbone_kind == "rwkv6")
        assert (cfg.ssm is not None) == (cfg.backbone_kind == "mamba2")
        assert cfg.has_shared_attn == jcfg.has_shared_attn
        assert cfg.padded_vocab == jcfg.padded_vocab


def test_validate_takes_ported_families_only():
    for arch in ("qwen3-0.6b", *ARCHS):
        get_config(arch).validate()
    base = get_config("qwen3-0.6b")
    # all six of the reference's families are ported; one outside them
    # raises
    with pytest.raises(NotImplementedError, match="not ported"):
        dataclasses.replace(base, family="diffusion").validate()


def test_param_trees_match_reference(model):
    """Same keys, shapes and dtypes as the JAX tree, in f32 and in bf16
    (where w0, u, A_log, D and dt_bias stay f32), from both init_params
    and from_jax_params."""
    jcfg, _, cfg, _ = model
    for dtype in ("float32", "bfloat16"):
        jc = dataclasses.replace(jcfg, dtype=dtype)
        tc = dataclasses.replace(cfg, dtype=dtype)
        jtree = jax.device_get(j_init_params(jc, jax.random.PRNGKey(1)))
        want = {jax.tree_util.keystr(path): (leaf.shape, str(leaf.dtype))
                for path, leaf in jax.tree_util.tree_leaves_with_path(jtree)}
        for tree in (init_params(tc, seed=0, device="cpu"),
                     from_jax_params(jtree, device="cpu")):
            got = {jax.tree_util.keystr(path): (tuple(t.shape),
                                                str(t.dtype)[6:])
                   for path, t in jax.tree_util.tree_leaves_with_path(tree)}
            assert got == want
        assert "['embed']['head']" in want           # untied lm_head
        f32 = [k for k, (_, dt) in want.items() if dt == "float32"]
        assert dtype == "float32" or sorted(f32) == sorted(
            k for k in want if k.endswith(("['w0']", "['u']", "['A_log']",
                                           "['D']", "['dt_bias']")))


# ------------------------------------------------------------------- blocks
def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rwkv6_blocks_match_reference():
    jcfg, cfg = _configs("rwkv6-1.6b")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(2))
    jp = jax.tree.map(lambda t: t[0], jparams["blocks"]["rwkv"])
    p = from_jax_params(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(0)
    x, prev = _x(rng, (2, 37, cfg.d_model)), _x(rng, (2, cfg.d_model))
    want = jax.jit(functools.partial(j_rwkv6.rwkv6_time_mix, jcfg))(
        jp, jnp.asarray(x), jnp.asarray(prev))
    got = rwkv6.rwkv6_time_mix(cfg, p, torch.from_numpy(x),
                               torch.from_numpy(prev))
    for g, w in zip(got, want):                 # y, final state, last token
        _close(g, w)
    want = j_rwkv6.rwkv6_channel_mix(jcfg, jp, jnp.asarray(x),
                                     jnp.asarray(prev))
    got = rwkv6.rwkv6_channel_mix(cfg, p, torch.from_numpy(x),
                                  torch.from_numpy(prev))
    for g, w in zip(got, want):
        _close(g, w)
    nh, hd = rwkv6.dims(cfg)
    state = 0.1 * _x(rng, (2, nh, hd, hd))
    want = j_rwkv6.rwkv6_time_mix_decode(jcfg, jp, jnp.asarray(x[:, 0]),
                                         jnp.asarray(state),
                                         jnp.asarray(prev))
    got = rwkv6.rwkv6_time_mix_decode(cfg, p, torch.from_numpy(x[:, 0]),
                                      torch.from_numpy(state),
                                      torch.from_numpy(prev))
    for g, w in zip(got, want):
        _close(g, w)


def test_mamba2_blocks_match_reference():
    jcfg, cfg = _configs("zamba2-7b")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(3))
    jp = jax.tree.map(lambda t: t[0], jparams["blocks"]["mamba"])
    p = from_jax_params(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(1)
    x = _x(rng, (2, 37, cfg.d_model))
    want_y, want_c = jax.jit(functools.partial(j_mamba2.mamba2_forward,
                                               jcfg))(jp, jnp.asarray(x))
    got_y, got_c = mamba2.mamba2_forward(cfg, p, torch.from_numpy(x))
    _close(got_y, want_y)
    for name in ("conv_x", "conv_bc", "ssd"):
        _close(getattr(got_c, name), getattr(want_c, name))
    assert got_c.length == int(want_c.length) == 37
    x1 = _x(rng, (2, 1, cfg.d_model))
    want_y, want_c = j_mamba2.mamba2_decode(jcfg, jp, jnp.asarray(x1), want_c)
    got_y, got_c = mamba2.mamba2_decode(cfg, p, torch.from_numpy(x1), got_c)
    _close(got_y, want_y)
    for name in ("conv_x", "conv_bc", "ssd"):
        _close(getattr(got_c, name), getattr(want_c, name))


# ------------------------------------------------------------------- models
@pytest.mark.parametrize("S", [37, 16])
def test_forward_logits_match_reference(model, S):
    """A prime and a power-of-two prompt through the port's kernel path
    (the scans' plain versions on the CPU) against the JAX model."""
    jcfg, jparams, cfg, params = model
    tokens = np.random.default_rng(S).integers(0, cfg.vocab_size, (2, S))
    want = j_forward(jcfg, jparams, jnp.asarray(tokens, jnp.int32)).logits
    got = forward(cfg, params, torch.from_numpy(tokens)).logits
    _close(got, want)


@pytest.mark.parametrize("S", [37, 16])
def test_reference_path_matches_kernel_path(model, S):
    """``force_ref`` (the JAX models' own chunked scans, the reference
    attention and MLP) against the kernel path, the pair chip_smoke.py
    compares on the card. Held to the kernel path: RWKV6 magnifies f32
    rounding from layer to layer (chip_smoke.py's f64 witness measures it
    at full width), so two chunked evaluations that sum in other orders
    can differ by about 1e-4 at a logit though each is exact up to
    rounding."""
    _, _, cfg, params = model
    tokens = torch.from_numpy(
        np.random.default_rng(S).integers(0, cfg.vocab_size, (2, S)))
    _close(forward(cfg, params, tokens, force_ref=True).logits,
           forward(cfg, params, tokens).logits)


def _double(tree):
    if isinstance(tree, dict):
        return {k: _double(v) for k, v in tree.items()}
    return tree.double()


def test_rwkv6_chunked_scan_is_exact_in_f64():
    """The f64 witness chip_smoke.py runs at full width: fed f64 weights,
    the RWKV6 model computes in f64, and the chunked scan (the plain
    version, the kernel's arithmetic) meets the reference path (the JAX
    model's chunked math, itself held to the sequential oracle in f64 by
    tests/test_torch_chunked.py) to f64 rounding, so what separates the
    f32 evaluations is rounding."""
    cfg = reduced(get_config("rwkv6-1.6b"))
    params = _double(init_params(cfg, seed=0, device="cpu"))
    tokens = torch.from_numpy(
        np.random.default_rng(37).integers(0, cfg.vocab_size, (2, 37)))
    want = forward(cfg, params, tokens, force_ref=True).logits
    got = forward(cfg, params, tokens).logits
    assert want.dtype == got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-10)


def _leaves(cache) -> dict:
    """Tensor leaves of a decode cache by path (lengths and Nones dropped)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            cache, is_leaf=lambda t: isinstance(t, torch.Tensor)):
        key = jax.tree_util.keystr(path)
        if "length" not in key and getattr(leaf, "ndim", 0) > 0:
            out[key] = leaf
    return out


def test_prefill_then_decode_matches_reference(model, jax_step):
    """Prefill of 13 tokens, then 8 decode steps against the JAX
    ``decode_step(static_layers=True)``: logits every step, and every state
    and KV leaf after the last."""
    jcfg, jparams, cfg, params = model
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 13))
    jout = j_forward(jcfg, jparams, jnp.asarray(tokens, jnp.int32),
                     return_cache=True, cache_capacity=32)
    out = forward(cfg, params, torch.from_numpy(tokens), return_cache=True,
                  cache_capacity=32)
    jcache, cache = jout.cache, out.cache
    for step in range(8):
        tok = np.array([[5 + step], [7 * step]], np.int32)
        jres = jax_step(jparams, jnp.asarray(tok), jcache)
        res = decode_step(cfg, params, torch.from_numpy(tok), cache)
        _close(res.logits, jres.logits)
        jcache, cache = jres.cache, res.cache
    want, got = _leaves(jcache), _leaves(cache)
    assert got.keys() == want.keys()
    for key in want:
        _close(got[key], want[key], err_msg=key, **TOL)


def test_init_decode_cache_matches_reference(model, jax_step):
    """Zeroed caches in the JAX layout; one decode step from them agrees."""
    jcfg, jparams, cfg, params = model
    jcache = j_init_decode_cache(jcfg, 2, 32)
    cache = init_decode_cache(cfg, 2, 32, device="cpu")
    want, got = _leaves(jcache), _leaves(cache)
    assert {k: tuple(v.shape) for k, v in got.items()} \
        == {k: tuple(v.shape) for k, v in want.items()}
    tok = np.array([[3], [9]], np.int32)
    jres = jax_step(jparams, jnp.asarray(tok), jcache)
    res = decode_step(cfg, params, torch.from_numpy(tok), cache)
    _close(res.logits, jres.logits)


# ------------------------------------------------------------------- engine
@pytest.mark.parametrize("use_scan", [False, True])
def test_generate_matches_reference_token_for_token(engines, use_scan):
    """Ragged budgets including 0, crossing chunk boundaries (chunk = 4),
    as in tests/test_engine_fast_path.py."""
    jeng, eng = engines
    prompts = np.ones((4, 8), dtype=np.int32)
    budgets = [5, 9, 0, 3]
    want = jeng.generate(prompts, budgets, max_extra_tokens=2,
                         use_scan=use_scan)
    got = eng.generate(prompts, budgets, max_extra_tokens=2,
                       use_scan=use_scan)
    for key in ("tokens", "n_generated", "n_reasoning"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["n_reasoning"], budgets)


def test_generate_eos_early_stop_matches_reference(engines):
    """EOS after the reasoning phase stops a row early in both packages, on
    both paths, at the same position."""
    jeng, eng = engines
    prompts = np.ones((2, 8), dtype=np.int32)
    budgets = [4, 6]
    eos = int(eng.generate(prompts, budgets, max_extra_tokens=6)
              ["tokens"][0, 4])                  # row 0's first answer token
    want = jeng.generate(prompts, budgets, max_extra_tokens=6,
                         eos_token=eos)
    for use_scan in (False, True):
        got = eng.generate(prompts, budgets, max_extra_tokens=6,
                           eos_token=eos, use_scan=use_scan)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["n_generated"], want["n_generated"])
    assert got["n_generated"][0] == 5 and got["n_reasoning"][0] == 4


# ------------------------------------------------------------------- server
def _small(core):
    prob = core.paper_problem()
    return core.Problem(tasks=prob.tasks,
                        server=core.ServerParams(0.1, 2.0, 64.0))


def test_server_report_and_tokens_match_reference(model):
    """``LLMServer`` + ``DecodeEngine`` on a 4-query stream (seed 2, prompts
    of 4-8 tokens): the reports agree to 1e-12 and every request's tokens
    exactly, as tests/test_torch_serving.py holds them for qwen3."""
    jcfg, jparams, cfg, params = model
    out = {}
    for name, core, qs, sv, eng in (
            ("jax", jcore, jqs, jserving,
             jserving.DecodeEngine(jcfg, jparams, cache_capacity=256)),
            ("torch", tcore, tqs, tserving,
             tserving.DecodeEngine(cfg, params, cache_capacity=256))):
        small = _small(core)
        stream = qs.generate_stream(small.tasks, 0.1, 4, seed=2,
                                    prompt_len_range=(4, 8))
        srv = sv.LLMServer(small, sv.ServerConfig(
            generate_tokens=True, max_extra_tokens=2,
            online_adaptation=False), engine=eng)
        seen = []
        orig = srv._engine_work

        def record(batch, orig=orig, seen=seen):
            orig(batch)
            seen.extend((r.rid, list(r.output_tokens)) for r in batch)
        srv._engine_work = record
        out[name] = (srv.run(stream), seen)
    (got, got_toks), (want, want_toks) = out["torch"], out["jax"]
    assert got.n == 4 and got.tokens_generated > 0
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
    assert got_toks == want_toks


def test_continuous_engine_refuses_recurrent_families(model):
    """The continuous engine refuses these families its paged pool, as the
    JAX engine does, and serves them in slot mode
    (tests/test_torch_continuous_recurrent.py)."""
    _, _, cfg, params = model
    with pytest.raises(ValueError, match="paged KV"):
        tserving.ContinuousBatchingEngine(cfg, params, max_slots=2,
                                          capacity=32, paged=True)
    eng = tserving.ContinuousBatchingEngine(cfg, params, max_slots=2,
                                            capacity=32)
    assert eng.admit(0, np.arange(1, 6), 3, 1)
    while eng.n_active:
        done = eng.step_chunk()
    assert len(done[0].tokens) == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_family(arch, capsys):
    rep = serve.main(["--reduced", "--device", "cpu", "--real-engine",
                      "--queries", "2", "--arch", arch])
    assert rep["n"] == 2
    assert rep["tokens_generated"] > 0
    assert '"allocator_resolves": 1' in capsys.readouterr().out
