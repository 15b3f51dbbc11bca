"""The MoE family of the port (``models/moe.py``, ``MoEConfig``,
``deepseek-moe-16b`` and ``granite-moe-3b-a800m``) against ``repro``'s.

Both packages run the reduced configs (2 layers, d_model 256, f32, 4
experts top-2, deepseek with 1 shared expert, capacity factor 8) on the
JAX package's parameters (``from_jax_params``). Tolerances: configs,
parameter counts and trees exactly, the experts chosen exactly; the
router's weights and aux loss at 1e-6 (one f32 layer, the same operations
in another library); one MoE layer (capacity at factor 8 and at 1.25,
where pairs are dropped; ragged; dense; the buffer the card runs at
``C = T``) at rtol = 2e-5, the repo's f32 kernel tolerance (sums over d
and d_expert in other orders), and atol = 2e-5 times the output's
largest |y|: a sum's rounding scales with its largest terms, and the JAX
package's ``_he`` takes the routed experts' fan-in to be E, so |y| of a
reduced layer reaches a few hundred (the JAX package's own dense and
ragged dispatch differ by up to 1.2e-4 there); prefill logits and 8 decode steps
at 1e-4, as ``tests/test_torch_model.py`` (two layers of such sums);
greedy tokens of ``DecodeEngine``, of the slot and paged continuous
engines and of B = 1 admissions under capacity dispatch exactly, against
the JAX engines'. The static-buffer decode step (the CUDA graph's code
path, run eagerly here) must give the per-token loop's tokens with one
capture across budgets.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import ref as jref
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import moe as j_moe
from repro.models import reduced as j_reduced
from repro.serving import DecodeEngine as JDecodeEngine
from repro.serving.continuous import ContinuousBatchingEngine as JContinuous
from repro_torch.configs import ARCH_IDS, NOT_YET_PORTED, get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_ffn import fused_ffn, fused_ffn_plain
from repro_torch.launch import serve
from repro_torch.models import (decode_step, forward, init_params, moe,
                                reduced)
from repro_torch.models.config import MoEConfig
from repro_torch.obs import graph_hooks
from repro_torch.serving import ContinuousBatchingEngine, DecodeEngine
from repro_torch.weights import from_jax_params
from repro_torch.compat import cap_xdist_threads

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_RTOL = 2e-5
ROUTE_TOL = dict(rtol=1e-6, atol=1e-6)
ARCHS = ["deepseek-moe-16b", "granite-moe-3b-a800m"]


@pytest.fixture(autouse=True)
def _clean_counters():
    graph_hooks.reset()
    yield
    graph_hooks.reset()


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = j_reduced(j_get_config(request.param))
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config(request.param))
    params = from_jax_params(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def deepseek():
    jcfg = j_reduced(j_get_config("deepseek-moe-16b"))
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, reduced(get_config("deepseek-moe-16b")), \
        from_jax_params(jax.device_get(jparams), device="cpu")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _layer(jparams, params, i: int = 0):
    """Layer ``i``'s MoE parameters: (JAX tree, port tree)."""
    jp = jax.tree_util.tree_map(lambda a: a[i], jparams["blocks"]["moe"])
    return jp, {k: (v[i] if isinstance(v, torch.Tensor)
                    else {kk: vv[i] for kk, vv in v.items()})
                for k, v in params["blocks"]["moe"].items()}


def _tokens(cfg, T: int, seed: int, skew: float = 0.0) -> np.ndarray:
    """[T, d] f32 activations; ``skew`` adds one shared direction to every
    row, so most rows pick the same experts (and overflow a capacity)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, cfg.d_model))
    return (x + skew * rng.standard_normal(cfg.d_model)).astype(np.float32)


def _close_layer(got, want) -> None:
    """rtol 2e-5, atol 2e-5 of the output's largest |y| (module doc)."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=LAYER_RTOL,
                               atol=LAYER_RTOL * float(np.abs(want).max()))


def _with_moe(cfg, **kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """Every field of the port's config equals the JAX config's, full and
    reduced, the MoE sub-config field for field (the ssm / rwkv ones,
    which a MoE never reads, are None in the port); the block kinds; the
    paged pool takes the family."""
    assert arch in ARCH_IDS and arch not in NOT_YET_PORTED
    for cfg, jcfg in ((get_config(arch), j_get_config(arch)),
                      (reduced(get_config(arch)),
                       j_reduced(j_get_config(arch)))):
        for f in dataclasses.fields(cfg):
            got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
            if f.name == "moe":
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            elif dataclasses.is_dataclass(want):
                assert got is None, f.name
            else:
                assert got == want, f.name
        assert cfg.block_kinds == jcfg.block_kinds == ("moe",) * cfg.n_layers
        assert cfg.hd == jcfg.hd and cfg.padded_vocab == jcfg.padded_vocab
        cfg.validate()
        cfg.validate(paged=True)


def test_only_the_vlm_and_audio_ids_are_unported():
    """Since the VLM and audio ids came across, none is left: the port's
    registry is the JAX package's, as a set."""
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    assert NOT_YET_PORTED == ()
    assert set(ARCH_IDS) == set(J_ARCH_IDS)
    for arch in J_ARCH_IDS:
        assert get_config(arch).arch_id == arch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_reference(arch):
    """The analytic counts, the reference's formula, on every ported id."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


def test_moe_param_counts_match_published_sizes():
    """``tests/test_configs_smoke.py``'s bands (billions) and DeepSeek-MoE's
    ~2.8 B active (2 shared + top-6)."""
    for arch, (lo, hi) in (("deepseek-moe-16b", (15.0, 18.0)),
                           ("granite-moe-3b-a800m", (2.5, 4.0))):
        assert lo <= get_config(arch).param_count() / 1e9 <= hi, arch
    active = get_config("deepseek-moe-16b").active_param_count() / 1e9
    assert 2.0 <= active <= 3.5


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_keeps_the_smoke_sizes(arch):
    """``tests/test_configs_smoke.py``'s smoke contract: 2 layers, d_model
    <= 512, at most 4 experts; top-2, one shared expert at most, capacity
    factor 8."""
    cfg = reduced(get_config(arch))
    cfg.validate()
    assert cfg.n_layers == 2 and cfg.d_model <= 512
    assert cfg.moe.n_experts <= 4 and cfg.moe.top_k == 2
    assert cfg.moe.n_shared_experts <= 1
    assert cfg.moe.capacity_factor == 8.0 and cfg.moe.d_expert >= 32


def test_validate_refuses_a_broken_moe_config():
    cfg = get_config("granite-moe-3b-a800m")
    for bad in (dataclasses.replace(cfg, moe=None),
                _with_moe(cfg, top_k=41),
                _with_moe(cfg, n_experts=0),
                _with_moe(cfg, impl="megablocks")):
        with pytest.raises(ValueError):
            bad.validate()
    assert MoEConfig().impl == "capacity"


def test_param_trees_match_reference(model):
    """Same keys, shapes and dtypes as the JAX tree, from both
    ``init_params`` and ``from_jax_params``; the port's own draws at the
    JAX package's ``_he`` scales (fan-in d for the router and the shared
    gate and up, E for the routed experts, d_expert * n_shared for the
    shared down), within 5% in standard deviation."""
    jcfg, _, cfg, _ = model
    jtree = jax.device_get(j_init_params(jcfg, jax.random.PRNGKey(1)))

    def layout(tree):
        return {jax.tree_util.keystr(path): (tuple(leaf.shape),
                                             str(leaf.dtype).split(".")[-1])
                for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    want = layout(jtree)
    mine = init_params(cfg, seed=0, device="cpu")
    for tree in (mine, from_jax_params(jtree, device="cpu")):
        assert layout(tree) == want
        assert ("shared" in tree["blocks"]["moe"]) \
            == bool(cfg.moe.n_shared_experts)
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jtree["blocks"]["moe"]):
        got = mine["blocks"]["moe"]
        for key in path:
            got = got[key.key]
        ref_std = float(np.std(leaf))
        assert abs(float(got.std()) / ref_std - 1) < 0.05, path


# ------------------------------------------------------------------- layers
def test_route_matches_reference(model):
    jcfg, jparams, cfg, params = model
    jp, p = _layer(jparams, params)
    x = _tokens(cfg, 24, seed=0)
    jw, jidx, jaux = j_moe._route(jcfg, jp, jnp.asarray(x))
    w, idx, probs = moe._route(cfg, p, torch.from_numpy(x))
    aux = moe._aux_loss(cfg, probs, idx)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(_np(w), _np(jw), **ROUTE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **ROUTE_TOL)


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_capacity_matches_reference(model, cf):
    """Capacity dispatch at the smoke factor 8 (nothing dropped) and at the
    configs' 1.25 on rows skewed towards a few experts, where pairs are
    really dropped (the later pairs of an overflowing expert)."""
    jcfg, jparams, cfg, params = model
    jcfg, cfg = _with_moe(jcfg, capacity_factor=cf), \
        _with_moe(cfg, capacity_factor=cf)
    jp, p = _layer(jparams, params)
    x = _tokens(cfg, 40, seed=1, skew=0.0 if cf == 8.0 else 3.0)
    jw, jidx, _ = j_moe._route(jcfg, jp, jnp.asarray(x))
    w, idx, _ = moe._route(cfg, p, torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    T, k = idx.shape
    C = max(1, int(T * k * cf / cfg.moe.n_experts))
    _, pos, _ = moe._expert_ranks(cfg.moe.n_experts, idx)
    dropped = int((pos >= C).sum())
    assert (dropped > 0) == (cf == 1.25), dropped
    want = j_moe._moe_capacity(jcfg, jp, jnp.asarray(x), jw, jidx)
    for force_ref in (False, True):
        got = moe._moe_capacity(cfg, p, torch.from_numpy(x), w, idx,
                                force_ref=force_ref)
        _close_layer(got, want)


def test_ragged_and_dense_match_reference(model):
    """The dropless dispatches against each other and the JAX package's:
    ragged (sorted rows, as on the CPU), the buffer at C = T that the card
    runs for it, and the dense oracle."""
    jcfg, jparams, cfg, params = model
    jp, p = _layer(jparams, params, 1)
    x = _tokens(cfg, 17, seed=2)
    jx = jnp.asarray(x)
    jw, jidx, _ = j_moe._route(jcfg, jp, jx)
    w, idx, _ = moe._route(cfg, p, torch.from_numpy(x))
    want = j_moe._moe_ragged(jcfg, jp, jx, jw, jidx)
    _close_layer(j_moe._moe_dense(jcfg, jp, jx, jw, jidx), want)
    xt = torch.from_numpy(x)
    for got in (moe._moe_ragged(cfg, p, xt, w, idx),
                moe._moe_ragged(cfg, p, xt, w, idx, force_ref=True),
                moe._moe_buffered(cfg, p, xt, w, idx, C=17),
                moe._moe_dense(cfg, p, xt, w, idx)):
        _close_layer(got, _np(want))


def test_expert_ranks_follow_the_stable_sort():
    """Each pair's rank in its expert is its place in the JAX package's
    stable argsort of the flat experts; the group sizes its bincount."""
    idx = np.random.default_rng(3).integers(0, 6, (50, 3))
    flat_e, pos, sizes = moe._expert_ranks(6, torch.from_numpy(idx))
    flat = idx.reshape(-1)
    order = np.argsort(flat, kind="stable")
    starts = np.cumsum(np.bincount(flat, minlength=6)) \
        - np.bincount(flat, minlength=6)
    want = np.empty_like(flat)
    want[order] = np.arange(flat.size) - starts[flat[order]]
    np.testing.assert_array_equal(pos.numpy(), want)
    np.testing.assert_array_equal(sizes.numpy(),
                                  np.bincount(flat, minlength=6))
    assert sizes.dtype == torch.int32


def _stable_sort_ranks(flat: np.ndarray, E: int, C: int) -> tuple:
    """The numpy oracle of the pair ranks: each pair's place in the stable
    argsort of the flat experts less its expert's start, the bincount,
    and the capacity dispatch's buffer rows."""
    counts = np.bincount(flat, minlength=E)
    order = np.argsort(flat, kind="stable")
    pos = np.empty_like(flat)
    starts = np.cumsum(counts) - counts
    pos[order] = np.arange(flat.size) - starts[flat[order]]
    slot = flat * C + pos
    return (pos, counts, np.where(pos < C, slot, E * C),
            np.where(pos < C, slot, flat[0] * C))


def ranks_case(kind: str, E: int, T: int, k: int) -> np.ndarray:
    """idx [T, k] int64 of a ranks case: ``random`` experts, ``one``
    (every pair to expert E // 2), ``sparse`` (a quarter of the experts
    get every pair, the rest none)."""
    rng = np.random.default_rng(E * 100003 + T * k)
    if kind == "one":
        return np.full((T, k), E // 2, np.int64)
    if kind == "sparse":
        return rng.choice(np.arange(1, E, 4), size=(T, k)).astype(np.int64)
    return rng.integers(0, E, (T, k)).astype(np.int64)


#: (kind, E, T, k): T k of 1, 17 x 6, 384 (a 64-row decode step) and
#: 15,000 (a 2,500-token prompt) pairs over 6, 40 and 64 experts; every
#: pair to one expert; experts with no pair
RANKS_CASES = ([("random", E, T, k) for E in (6, 40, 64)
                for T, k in ((1, 1), (17, 6), (64, 6), (2500, 6))]
               + [("one", 64, 64, 6), ("sparse", 40, 17, 6),
                  ("sparse", 64, 2500, 6)])


@pytest.mark.parametrize("kind,E,T,k", RANKS_CASES)
def test_moe_ranks_plain_follows_the_stable_sort(kind, E, T, k):
    """The ranks' plain version (the oracle the kernel is held to) against
    the numpy stable argsort: ranks, group sizes, and the buffer rows at a
    capacity that drops pairs and at C = T, which drops none."""
    from repro_torch.kernels.moe_ranks import moe_ranks_plain

    idx = ranks_case(kind, E, T, k)
    flat = idx.reshape(-1)
    for C in (max(1, int(T * k * 1.25 / E)), T):
        want = _stable_sort_ranks(flat, E, C)
        pos, sizes, rows_in, rows_out = moe_ranks_plain(
            torch.from_numpy(idx), E, C)
        for got, ref_ in zip((pos, sizes, rows_in, rows_out), want):
            np.testing.assert_array_equal(got.numpy(), ref_)
        assert pos.dtype == rows_in.dtype == torch.int64
        assert sizes.dtype == torch.int32
    pos0, sizes0, none_in, none_out = moe_ranks_plain(torch.from_numpy(idx),
                                                      E)
    assert torch.equal(pos0, pos) and torch.equal(sizes0, sizes)
    assert none_in is None and none_out is None


def test_grouped_ffn_ref_matches_reference():
    """The sorted-rows oracle, with an empty group in the middle and at the
    end."""
    rng = np.random.default_rng(4)
    E, d, f = 5, 48, 40
    sizes = np.array([3, 0, 6, 2, 0], np.int32)
    x = rng.standard_normal((int(sizes.sum()), d)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.2
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    want = jref.grouped_ffn_ref(jnp.asarray(x), *map(jnp.asarray, ws),
                                jnp.asarray(sizes))
    got = ref.grouped_ffn_ref(torch.from_numpy(x),
                              *map(torch.from_numpy, ws),
                              torch.from_numpy(sizes))
    _close_layer(got, _np(want))


def test_fused_ffn_rows_on_the_valid_rows():
    """``rows`` leaves the valid rows (``< rows[e]``) of the plain version,
    the CPU wrapper and ``ops`` (kernel and oracle path) as without it,
    at E 6 with empty experts, against the JAX package's oracle."""
    rng = np.random.default_rng(5)
    E, C, d, f = 6, 9, 64, 48
    rows = torch.tensor([0, 9, 3, 0, 1, 7], dtype=torch.int32)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.2
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    want = _np(jref.fused_ffn_ref(jnp.asarray(x), *map(jnp.asarray, ws)))
    tx, tws = torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
    valid = (torch.arange(C)[None] < rows[:, None]).numpy()
    for got in (fused_ffn_plain(tx, *tws, rows=rows),
                fused_ffn(tx, *tws, rows=rows),
                ops.fused_ffn(tx, *tws, rows=rows),
                ops.fused_ffn(tx, *tws, rows=rows, force_ref=True)):
        _close_layer(_np(got)[valid], want[valid])
    np.testing.assert_array_equal(_np(fused_ffn(tx, *tws, rows=rows)),
                                  _np(fused_ffn(tx, *tws)))


@pytest.mark.parametrize("force_ref", [False, True])
def test_moe_forward_matches_reference(model, force_ref):
    """The whole layer (route, dispatch, shared experts, aux) at a prefill
    shape (capacity) and a decode shape (S = 1: dropless)."""
    jcfg, jparams, cfg, params = model
    jp, p = _layer(jparams, params)
    for shape, seed in (((2, 7), 6), ((3, 1), 7)):
        x = _tokens(cfg, shape[0] * shape[1], seed).reshape(
            *shape, cfg.d_model)
        jy, jaux = j_moe.moe_forward(jcfg, jp, jnp.asarray(x))
        y, aux = moe.moe_forward(cfg, p, torch.from_numpy(x),
                                 force_ref=force_ref)
        assert y.shape == x.shape
        _close_layer(y, _np(jy))
        np.testing.assert_allclose(float(aux), float(jaux), **ROUTE_TOL)


def test_moe_apply_is_forward_without_aux(model):
    """The decode step's ``moe_apply`` gives ``moe_forward``'s output bit
    for bit, and the routing the aux loss is taken from."""
    _, jparams, cfg, params = model
    _, p = _layer(jparams, params)
    for shape, seed in (((2, 7), 6), ((3, 1), 7)):
        x = torch.from_numpy(_tokens(cfg, shape[0] * shape[1], seed)
                             .reshape(*shape, cfg.d_model))
        y, aux = moe.moe_forward(cfg, p, x)
        ya, probs, idx = moe.moe_apply(cfg, p, x)
        assert torch.equal(ya, y)
        assert torch.equal(moe._aux_loss(cfg, probs, idx), aux)
        _, ridx, rprobs = moe._route(cfg, p, x.reshape(-1, cfg.d_model))
        assert torch.equal(idx, ridx) and torch.equal(probs, rprobs)


def test_shared_experts_kernel_and_reference_paths(deepseek):
    """deepseek's shared experts through the fused FFN (plain on the CPU)
    and through the reference's einsum chain."""
    _, jparams, cfg, params = deepseek
    _, p = _layer(jparams, params)
    x = torch.from_numpy(_tokens(cfg, 11, seed=8))
    np.testing.assert_allclose(
        _np(moe._shared_experts(p["shared"], x, False)),
        _np(moe._shared_experts(p["shared"], x, True)))


# ------------------------------------------------------------------- models
@pytest.mark.parametrize("force_ref", [False, True])
def test_forward_logits_match_reference(model, force_ref):
    """Prefill logits (capacity dispatch) and the summed aux loss."""
    jcfg, jparams, cfg, params = model
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
    jout = j_forward(jcfg, jparams, jnp.asarray(tokens, jnp.int32))
    out = forward(cfg, params, torch.from_numpy(tokens), force_ref=force_ref)
    np.testing.assert_allclose(_np(out.logits), _np(jout.logits), **TOL)
    assert out.aux_loss.dtype == torch.float32 and out.aux_loss.dim() == 0
    np.testing.assert_allclose(float(out.aux_loss), float(jout.aux_loss),
                               **ROUTE_TOL)


def test_dense_forward_aux_loss_is_zero():
    cfg = reduced(get_config("qwen3-0.6b"))
    out = forward(cfg, init_params(cfg, seed=0, device="cpu"),
                  torch.ones(1, 5, dtype=torch.long))
    assert float(out.aux_loss) == 0.0


def test_prefill_then_decode_matches_reference(model):
    """Prefill of 13 tokens into a cache of 32, then 8 greedy decode steps
    (S = 1: dropless) against the JAX ``decode_step(static_layers=True)``:
    logits every step, each side's greedy tokens equal."""
    jcfg, jparams, cfg, params = model
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 13))
    jout = j_forward(jcfg, jparams, jnp.asarray(tokens, jnp.int32),
                     return_cache=True, cache_capacity=32)
    out = forward(cfg, params, torch.from_numpy(tokens), return_cache=True,
                  cache_capacity=32)
    np.testing.assert_allclose(_np(out.logits), _np(jout.logits), **TOL)
    jcache, cache = jout.cache, out.cache
    jtok = jnp.argmax(jout.logits[:, -1:], -1).astype(jnp.int32)
    tok = out.logits[:, -1:].argmax(-1)
    step = jax.jit(lambda p, t, c: j_decode_step(jcfg, p, t, c,
                                                 static_layers=True))
    for _ in range(8):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jres = step(jparams, jtok, jcache)
        res = decode_step(cfg, params, tok, cache)
        np.testing.assert_allclose(_np(res.logits), _np(jres.logits), **TOL)
        jcache, cache = jres.cache, res.cache
        jtok = jnp.argmax(jres.logits, -1).astype(jnp.int32)
        tok = res.logits.argmax(-1)
    assert int(cache["layers"].length) == 21


# ------------------------------------------------------------------ engines
PROMPTS = np.ones((4, 8), dtype=np.int32)
BUDGETS = [5, 9, 0, 3]


def test_decode_engine_matches_reference(model):
    """``tests/test_engine_fast_path.py``'s MoE case (4 prompts of 8 ones,
    budgets with a zero, chunk 4) against the JAX engine, on the chunk
    path and the per-token loop."""
    jcfg, jparams, cfg, params = model
    want = JDecodeEngine(jcfg, jparams, cache_capacity=64, chunk=4) \
        .generate(PROMPTS, BUDGETS, max_extra_tokens=2)
    eng = DecodeEngine(cfg, params, cache_capacity=64, chunk=4)
    for use_scan in (True, False):
        got = eng.generate(PROMPTS, BUDGETS, max_extra_tokens=2,
                           use_scan=use_scan)
        for key in ("tokens", "n_generated", "n_reasoning"):
            np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["n_reasoning"], BUDGETS)


@pytest.fixture(scope="module")
def requests():
    """``tests/test_paged.py``'s fixture, its first 6 requests."""
    rng = np.random.default_rng(0)
    return [(i,
             rng.integers(1, 97, size=int(rng.integers(3, 20))).astype(
                 np.int32),
             int(rng.integers(1, 12)), 4) for i in range(10)][:6]


def drain(eng, reqs, chunk=None, use_step=False):
    """Admit-all/step loop; the tokens per request and the admission
    groups' request ids."""
    groups = []
    admit = eng._admit_group

    def record(group):
        groups.append([req[0] for _, req in group])
        admit(group)
    eng._admit_group = record
    pending, done = list(reqs), {}
    while pending or eng.n_active:
        if pending:
            flags = eng.admit_many(pending)
            pending = [r for r, ok in zip(pending, flags) if not ok]
        for s in (eng.step() if use_step else eng.step_chunk(chunk)):
            done[s.rid] = s.tokens
    return done, groups


def test_continuous_slot_and_paged_match_reference(model, requests):
    """``tests/test_paged.py::test_paged_moe_backbone`` on the port (3
    slots, capacity 64, chunk 4, blocks of 8): the paged drain equals the
    slot drain and both equal the JAX engine's; capacity dispatch admits
    one request a group."""
    jcfg, jparams, cfg, params = model
    kw = dict(max_slots=3, capacity=64, chunk=4)
    want, _ = drain(JContinuous(jcfg, jparams, **kw), requests)
    slot, groups = drain(ContinuousBatchingEngine(cfg, params, **kw),
                         requests)
    paged, _ = drain(ContinuousBatchingEngine(cfg, params, paged=True,
                                              block_size=8, **kw), requests)
    assert slot == want and paged == want
    assert all(len(g) == 1 for g in groups) and len(groups) == 6


def test_capacity_admissions_stay_solo(deepseek):
    """``tests/test_continuous_batching.py::
    test_moe_capacity_admissions_stay_solo`` on the port: at capacity
    factor 1.25 rows compete for capacity slots, so admissions prefill
    one request at a time and each request's tokens are those it gets
    served alone, and the JAX engine's."""
    jcfg, jparams, cfg, params = deepseek
    jcfg, cfg = _with_moe(jcfg, capacity_factor=1.25), \
        _with_moe(cfg, capacity_factor=1.25)
    prompts = [np.arange(1, 9, dtype=np.int32),
               np.arange(2, 10, dtype=np.int32)]
    budgets = [4, 5]
    eng = DecodeEngine(cfg, params, cache_capacity=64)
    jeng = JDecodeEngine(jcfg, jparams, cache_capacity=64)
    refs = []
    for pr, b in zip(prompts, budgets):
        out = eng.generate(pr[None, :], [b], max_extra_tokens=1)
        jout = jeng.generate(pr[None, :], [b], max_extra_tokens=1)
        np.testing.assert_array_equal(out["tokens"], jout["tokens"])
        refs.append(out["tokens"][0, :out["n_generated"][0]].tolist())
    cb = ContinuousBatchingEngine(cfg, params, max_slots=2, capacity=64,
                                  chunk=3)
    assert cb._batch_rows() == 1 and not cb._can_pad_batch()
    done, groups = drain(cb, [(i, prompts[i], budgets[i], 1)
                              for i in range(2)])
    assert groups == [[0], [1]]
    assert done[0] == refs[0] and done[1] == refs[1]


@pytest.mark.parametrize("impl", ["capacity", "ragged", "dense"])
def test_admission_rules_match_reference(deepseek, impl):
    """``_batch_rows``, ``_can_pad_batch`` and ``_can_page`` per dispatch,
    as the JAX engine's: only capacity dispatch prefills one at a time."""
    jcfg, jparams, cfg, params = deepseek
    jeng = JContinuous(_with_moe(jcfg, impl=impl), jparams, max_slots=3,
                       capacity=16)
    eng = ContinuousBatchingEngine(_with_moe(cfg, impl=impl), params,
                                   max_slots=3, capacity=16)
    assert eng._batch_rows() == jeng._batch_rows() \
        == (1 if impl == "capacity" else 3)
    assert eng._can_pad_batch() == jeng._can_pad_batch() \
        == (impl != "capacity")
    assert eng._can_page() and jeng._can_page()


# ---------------------------------------------- the static-buffer step
def test_static_step_matches_loop_one_capture(model):
    """``DecodeEngine``'s step over static buffers (the CUDA graph's code
    path) at chunks 1, 4 and 16 against the per-token loop, one capture
    for a chunk across two calls with other budgets and prompts."""
    _, _, cfg, params = model
    for chunk in (1, 4, 16):
        graph_hooks.reset()
        eng = DecodeEngine(cfg, params, cache_capacity=64, chunk=chunk)
        for prompts, budgets in ((PROMPTS, BUDGETS),
                                 (PROMPTS * 3 + 1, [2, 0, 11, 7])):
            got = eng.generate(prompts, budgets, max_extra_tokens=2)
            loop = eng.generate(prompts, budgets, max_extra_tokens=2,
                                use_scan=False)
            for key in ("tokens", "n_generated", "n_reasoning"):
                np.testing.assert_array_equal(got[key], loop[key])
        assert graph_hooks.assert_max_captures("engine.chunk", 1) == 1


@pytest.mark.parametrize("paged", [False, True])
def test_continuous_static_step_matches_per_token_drain(model, requests,
                                                        paged):
    """The continuous engine's static-buffer chunk (16 and 1) against its
    per-token ``step``, one capture across the admissions."""
    _, _, cfg, params = model
    kw = dict(max_slots=3, capacity=64, paged=paged, block_size=8)
    want, _ = drain(ContinuousBatchingEngine(cfg, params, **kw), requests,
                    use_step=True)
    label = "continuous.paged" if paged else "continuous.slot"
    for chunk in (16, 1):
        graph_hooks.reset()
        got, _ = drain(ContinuousBatchingEngine(cfg, params, chunk=chunk,
                                                **kw), requests)
        assert got == want
        assert graph_hooks.assert_max_captures(label, 1) == 1


# ----------------------------------------------------------------- launcher
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_id(arch, capsys):
    rep = serve.main(["--reduced", "--device", "cpu", "--real-engine",
                      "--queries", "2", "--arch", arch])
    assert rep["n"] == 2 and rep["tokens_generated"] > 0
    assert '"allocator_resolves": 1' in capsys.readouterr().out
