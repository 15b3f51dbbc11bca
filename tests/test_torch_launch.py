"""The port's launch layer (shapes, steps, dry-run) and roofline against the
JAX package's, and ``kv_repeat``.

* ``SHAPES`` and ``adapt_config`` equal the JAX package's; the per-device
  shapes of ``input_specs``' DTensor stand-ins on the production meshes
  (PyTorch's fake process group) equal what the JAX package's specs give
  on the same mesh sizes.
* The three steps at reduced size against the JAX steps: the prefill's
  last-position logits and the serve step's logits within 1e-4, the train
  step's loss within 1e-5.
* ``model_flops`` equal for every id x shape; the collective sums of
  ``tests/test_perf_features.py`` as records; the roofline terms with the
  H100 constants; the step counter's FLOPs and bytes (a plain matmul, the
  attention pairs a mask keeps in the forward and the backward, plain
  and checkpointed, and the rows a gather reads).
* ``kv_repeat`` (``tests/test_perf_features.py``'s consistency case, and
  the widened JAX tree carried across by ``from_jax_params``).
* The dry-run CLI for ``qwen3-0.6b`` x ``decode_32k`` x pod in a
  subprocess, and ``roofline_combo``'s depth extrapolation equal to the
  direct full-depth count for a dense and a hybrid id.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.launch import shapes as jshapes
from repro.launch import steps as jsteps
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_decode_cache as j_init_decode_cache
from repro.models import init_params as j_init_params
from repro.models import reduced as j_reduced
from repro.roofline import analysis as janalysis
from repro.sharding import partition as jpart
from repro.train import init_opt_state as j_init_opt_state
from repro.train.trainer import TrainState as JTrainState
from repro_torch.compat import cap_xdist_threads
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, shapes, steps
from repro_torch.models import (decode_step, forward, init_params, reduced)
from repro_torch.roofline import analysis
from repro_torch.sharding import partition as part
from repro_torch.train import init_opt_state
from repro_torch.train.trainer import TrainState
from repro_torch.weights import from_jax_params

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _local_shape(shape, spec, sizes) -> tuple:
    """Per-device shape of a leaf under a JAX spec (ceil division)."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        if ax is not None:
            axes = ax if isinstance(ax, tuple) else (ax,)
            dim = -(-dim // math.prod(sizes[a] for a in axes))
        out.append(dim)
    return tuple(out)


# ----------------------------------------------------------------- shapes
def test_shapes_match_reference():
    assert set(shapes.SHAPES) == set(jshapes.SHAPES)
    for name, sh in shapes.SHAPES.items():
        assert dataclasses.asdict(sh) == dataclasses.asdict(
            jshapes.SHAPES[name])
    assert shapes.LONG_CONTEXT_WINDOW == jshapes.LONG_CONTEXT_WINDOW


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_adapt_config_matches_reference(arch):
    for name, sh in shapes.SHAPES.items():
        got = shapes.adapt_config(get_config(arch), sh)
        want = jshapes.adapt_config(j_get_config(arch), jshapes.SHAPES[name])
        assert got.sliding_window == want.sliding_window, (arch, name)
        assert got.n_layers == want.n_layers


@pytest.fixture(scope="module")
def pod_meshes():
    """The production meshes on PyTorch's fake process group, torn down
    after the module's tests."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    meshes = {}
    try:
        meshes["pod"] = make_production_mesh()
        yield meshes
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_per_device_shapes(arch, pod_meshes):
    """Every stand-in's local shard shape equals the JAX package's spec's
    per-device shape on the (16, 16) pod, each of the four shapes."""
    mesh = pod_meshes["pod"]
    fm = FakeMesh({"data": 16, "model": 16})
    sizes = fm.shape
    for name, sh in shapes.SHAPES.items():
        spec = shapes.input_specs(get_config(arch), sh, mesh)
        jcfg = jshapes.adapt_config(j_get_config(arch), jshapes.SHAPES[name])
        tok = jpart.token_spec(fm, sh.batch)
        if sh.kind == "train":
            t = spec["batch"]["tokens"]
            text = sh.seq - jcfg.n_prefix_embeds
            assert tuple(t.shape) == (sh.batch, text + 1)
            assert tuple(t.to_local().shape) == _local_shape(
                (sh.batch, text + 1), tok, sizes)
        elif sh.kind == "prefill":
            t = spec["tokens"]
            text = sh.seq - jcfg.n_prefix_embeds
            assert tuple(t.to_local().shape) == _local_shape(
                (sh.batch, text), tok, sizes)
            if jcfg.n_prefix_embeds:
                pe = spec["prefix_embeds"]
                assert tuple(pe.to_local().shape) == _local_shape(
                    (sh.batch, jcfg.n_prefix_embeds, jcfg.d_model), tok,
                    sizes)
        else:
            assert tuple(spec["token"].to_local().shape) == _local_shape(
                (sh.batch, 1), tok, sizes)
            jc = jax.eval_shape(lambda: j_init_decode_cache(
                jcfg, sh.batch, sh.seq))
            fn = jpart.cache_spec(jcfg, fm, sh.batch)
            want = {}
            for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
                keys = tuple(str(getattr(k, "key", getattr(k, "name", "?")))
                             for k in path)
                if keys[-1] != "length":
                    want[keys] = _local_shape(leaf.shape, fn(path, leaf),
                                              sizes)
            got = {}
            part.tree_map_with_path(
                lambda p, t: got.__setitem__(tuple(p),
                                             tuple(t.to_local().shape)),
                spec["cache"])
            got = {k: v for k, v in got.items() if k[-1] != "length"}
            assert got == want, (arch, name)


def test_production_meshes():
    """(16, 16) data x model and (2, 16, 16) with pod, on fake groups of
    256 and 512 ranks, torn down after."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    try:
        m = make_production_mesh()
        assert m.mesh_dim_names == ("data", "model") and m.size() == 256
        m = make_production_mesh(multi_pod=True)
        assert m.mesh_dim_names == ("pod", "data", "model")
        assert tuple(m.shape) == (2, 16, 16) and m.size() == 512
        m = make_production_mesh(shape_override=(32, 8))
        assert m.mesh_dim_names == ("data", "model")
        assert part.mesh_shape(m) == {"data": 32, "model": 8}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ------------------------------------------------------------------ steps
@pytest.fixture(scope="module", params=["qwen3-0.6b", "starcoder2-3b"])
def step_pair(request):
    """Reduced id, JAX and port parameters, tokens longer than
    starcoder2's reduced window of 64 (the ring keeps the last 64)."""
    arch = request.param
    jcfg = j_reduced(j_get_config(arch))
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch))
    params = from_jax_params(jax.device_get(jparams), device="cpu")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 80)).astype(np.int32)
    return jcfg, jparams, cfg, params, toks


def test_prefill_and_serve_steps_match_reference(step_pair):
    jcfg, jparams, cfg, params, toks = step_pair
    jlog, jcache = jsteps.make_prefill_step(jcfg)(jparams, jnp.asarray(toks))
    plog, pcache = steps.make_prefill_step(cfg)(params, torch.from_numpy(toks))
    assert tuple(plog.shape) == tuple(jlog.shape) == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=1e-4)
    tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    jout, _ = jsteps.make_serve_step(jcfg)(jparams, jnp.asarray(tok), jcache)
    pout, pcache = steps.make_serve_step(cfg)(params, torch.from_numpy(tok),
                                              pcache)
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), atol=1e-4,
                               rtol=1e-4)
    assert int(pcache["layers"].length) == toks.shape[1] + 1


def test_train_step_matches_reference(step_pair):
    jcfg, jparams, cfg, params, toks = step_pair
    batch = toks[:, :33]
    _, jm = jax.jit(jsteps.make_train_step_fn(jcfg))(
        JTrainState(params=jparams, opt=j_init_opt_state(jparams)),
        {"tokens": jnp.asarray(batch)})
    _, pm = steps.make_train_step_fn(cfg)(
        TrainState(params=params, opt=init_opt_state(params)),
        {"tokens": torch.from_numpy(batch)})
    assert abs(float(pm["loss"]) - float(jm["loss"])) <= 1e-5


def test_prefill_step_last_logits_are_forwards():
    """The prefill step computes only the last position's logits; they
    are the full forward's last row (to f32 rounding: the head's product
    over one row and over all rows block differently)."""
    cfg = reduced(get_config("qwen3-0.6b"))
    params = init_params(cfg, 0, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(0))
    last, _ = steps.make_prefill_step(cfg)(params, toks)
    full = forward(cfg, params, toks).logits
    torch.testing.assert_close(last, full[:, -1:], rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- roofline
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_reference(arch):
    for name, sh in shapes.SHAPES.items():
        got = analysis.model_flops(shapes.adapt_config(get_config(arch), sh),
                                   sh)
        want = janalysis.model_flops(
            jshapes.adapt_config(j_get_config(arch), jshapes.SHAPES[name]),
            jshapes.SHAPES[name])
        assert got == want, (arch, name)


def test_roofline_collective_records():
    """``tests/test_perf_features.py``'s six HLO lines as the port's
    records: a tuple result is one record a result tensor, so the tuple
    all-to-all counts twice; the bytes are the reference's."""
    records = [("all-gather", torch.bfloat16, (128, 1024)),
               ("all-reduce", torch.float32, (256,)),
               ("all-to-all", torch.float32, (16, 16)),
               ("all-to-all", torch.float32, (16, 16)),
               ("collective-permute", torch.uint8, (512,)),
               ("all-reduce", torch.float32, (64,))]
    out = analysis.collective_bytes(records)
    hlo = """
      %ag = bf16[128,1024] all-gather(%x), dimensions={0}
      %ar.1 = f32[256] all-reduce(%y), to_apply=%sum
      %tup = (f32[16,16], f32[16,16]) all-to-all(%a, %b)
      %cp = u8[512] collective-permute(%z)
      %ars = f32[64] all-reduce-start(%w)
      %notacoll = f32[999] add(%p, %q)
    """
    want = janalysis.parse_collective_bytes(hlo)
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                 "collective-permute", "total"):
        assert out[kind] == want[kind], kind
    assert out["all-gather"] == 128 * 1024 * 2
    assert out["all-to-all"] == 2 * 16 * 16 * 4
    assert out["counts"]["all-to-all"] == 2
    assert out["counts"]["all-reduce"] == want["counts"]["all-reduce"] == 2


def test_roofline_terms_and_bottleneck():
    cfg = get_config("olmo-1b")
    cost = {"flops": 1e15, "bytes accessed": 1e12}
    r = analysis.analyze(cost, [("all-gather", torch.bfloat16, (1024, 1024))],
                         cfg, shapes.SHAPES["train_4k"], 256)
    assert r.compute_s == pytest.approx(1e15 / 989.4e12)
    assert r.memory_s == pytest.approx(1e12 / 3.35e12)
    assert r.collective_s == pytest.approx(1024 * 1024 * 2 / 50e9)
    assert r.bottleneck == "compute"
    assert r.model_flops_global == pytest.approx(
        6 * cfg.active_param_count() * 256 * 4096)


def test_step_counter_counts_a_plain_matmul():
    """Without a mesh the counter sees plain ops: a [64, 32] @ [32, 16]
    product is 2·64·32·16 FLOPs, no collective, and the step's only
    temporary is its output."""
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    res = analysis.count_step(lambda x, y: x @ y, (a, b))
    assert res["cost"]["flops"] == 2 * 64 * 32 * 16
    assert res["collectives"] == []
    assert res["memory"]["argument_size_in_bytes"] == (64 * 32 + 32 * 16) * 4
    assert res["memory"]["output_size_in_bytes"] == 64 * 16 * 4
    assert res["cost"]["bytes accessed"] == (64 * 32 + 32 * 16 + 64 * 16) * 4


@pytest.mark.parametrize("case", ["causal", "window", "valid_mask",
                                  "meta_mask"])
def test_step_counter_counts_kept_attention_pairs(case):
    """The reference attention's einsums compute every (query, key) pair;
    the count keeps 4·hd FLOPs per head for the pairs the mask keeps only:
    a causal prefill's S(S+1)/2 per row, a window's min(s + 1, W) per
    query, a decode mask's valid slots counted from its values, and
    every pair where the mask has none (meta)."""
    from repro_torch.models.attention import _sdpa, causal_mask, causal_pairs
    cfg = reduced(get_config("qwen3-0.6b"))
    B, S, nh, nkv, hd = 2, 9, 4, 2, 16
    dev = "meta" if case == "meta_mask" else "cpu"
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, S, nh, hd, generator=g).to(dev)
    k = torch.randn(B, S, nkv, hd, generator=g).to(dev)
    v = torch.randn(B, S, nkv, hd, generator=g).to(dev)
    pos = torch.arange(S)
    if case in ("causal", "window"):
        window = 4 if case == "window" else None
        c = dataclasses.replace(cfg, sliding_window=window)
        mask = causal_mask(c, pos, pos)
        pairs = causal_pairs(S, window)
        assert pairs == sum(min(s + 1, window or S) for s in range(S))
        assert int(mask.sum()) == pairs
        res = analysis.count_step(
            lambda q, k, v: _sdpa(c, q, k, v, mask, pairs), (q, k, v))
        kept = B * pairs
    else:
        lens = torch.tensor([3, 7])
        mask = (pos[None] < lens[:, None])[:, None, :].expand(B, S, S)
        mask = mask.to(dev)
        res = analysis.count_step(
            lambda q, k, v: _sdpa(cfg, q, k, v, mask), (q, k, v))
        kept = B * S * S if dev == "meta" else int(S * lens.sum())
    assert res["cost"]["flops"] == 4 * nh * hd * kept


@pytest.mark.parametrize("remat", [False, True])
def test_step_counter_counts_kept_pairs_in_the_backward(remat, monkeypatch):
    """A causal attention's forward and backward (four einsums of the
    score's size when q, k and v need gradients), plain and under
    activation checkpointing (whose recompute PyTorch may stop early):
    every einsum counts the kept pairs only, so the count is the
    uncredited one scaled by kept / all pairs."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models import attention as A
    cfg = reduced(get_config("qwen3-0.6b"))
    B, S, nh, nkv, hd = 2, 9, 4, 2, 16
    pos = torch.arange(S)
    mask, pairs = A.causal_mask(cfg, pos, pos), A.causal_pairs(S, None)

    def count():
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(B, S, n, hd, generator=g).requires_grad_()
                   for n in (nh, nkv, nkv))

        def step(q, k, v):
            def f(q, k, v):
                return A._sdpa(cfg, q, k, v, mask, pairs)
            out = checkpoint(f, q, k, v, use_reentrant=False) if remat \
                else f(q, k, v)
            out.sum().backward()
            return out.detach()
        return analysis.count_step(step, (q, k, v))["cost"]["flops"]
    kept = count()
    monkeypatch.setattr(A, "note_attention_scores", lambda *a, **k: 0)
    full = count()
    assert kept * (S * S) == full * pairs
    if not remat:
        assert kept == 6 * 2 * nh * hd * B * pairs


@pytest.mark.parametrize("whole", [False, True])
def test_step_counter_counts_gathered_rows(whole):
    """An argument read only through a gather (an embedding lookup)
    counts the bytes gathered from it; read by any other op as well, it
    counts whole."""
    tab = torch.ones(100, 8)
    idx = torch.tensor([3, 5, 3])
    if whole:
        res = analysis.count_step(lambda t, i: t[i] + t.sum(), (tab, idx))
        table_b = 100 * 8 * 4
    else:
        res = analysis.count_step(lambda t, i: t[i], (tab, idx))
        table_b = 3 * 8 * 4
    assert res["memory"]["argument_size_in_bytes"] == 100 * 8 * 4 + 3 * 8
    assert res["cost"]["bytes accessed"] == table_b + 3 * 8 + 3 * 8 * 4


# --------------------------------------------------------------- kv_repeat
def test_kv_repeat_consistency():
    """kv_repeat expands the KV projections; the model still satisfies
    decode == forward (it is a valid GQA model with more kv heads)."""
    base = reduced(get_config("qwen3-0.6b"))
    cfg2 = dataclasses.replace(base, n_kv_heads=1, kv_repeat=2)
    cfg2.validate()
    assert cfg2.n_kv_eff == 2
    with pytest.raises(ValueError, match="kv_repeat"):
        dataclasses.replace(base, kv_repeat=8).validate()
    params = init_params(cfg2, 0, "cpu")
    toks = torch.randint(0, cfg2.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    out = forward(cfg2, params, toks, return_cache=True, cache_capacity=24)
    nxt = out.logits[:, -1:].argmax(-1).to(torch.int32)
    dec = decode_step(cfg2, params, nxt, out.cache)
    ref = forward(cfg2, params, torch.cat([toks, nxt], 1))
    assert float((dec.logits[:, 0] - ref.logits[:, -1]).abs().max()) < 1e-3
    assert params["blocks"]["attn"]["wk"].shape[-1] == cfg2.n_kv_eff * cfg2.hd
    assert out.cache["layers"].k.shape[3] == cfg2.n_kv_eff


def test_kv_repeat_tree_from_jax():
    """The JAX package's widened tree carries across as it is; logits of
    both packages agree."""
    jcfg = dataclasses.replace(j_reduced(j_get_config("qwen3-0.6b")),
                               n_kv_heads=1, kv_repeat=2)
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b")),
                              n_kv_heads=1, kv_repeat=2)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.device_get(jparams), device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    want = j_forward(jcfg, jparams, jnp.asarray(toks, jnp.int32),
                     return_cache=True, cache_capacity=16)
    got = forward(cfg, params, torch.from_numpy(toks), return_cache=True,
                  cache_capacity=16)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=1e-4, rtol=1e-4)
    tok = np.zeros((2, 1), np.int32)
    jd = j_decode_step(jcfg, jparams, jnp.asarray(tok), want.cache)
    pd = decode_step(cfg, params, torch.from_numpy(tok), got.cache)
    np.testing.assert_allclose(pd.logits.numpy(), np.asarray(jd.logits),
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- dry-run
def test_dryrun_cli_single_combo(tmp_path):
    """One production-mesh combo through the CLI, in a subprocess: its
    per-device argument bytes are the local shards the JAX package's specs
    give (parameters, token, cache; the port's one 0-d cache position in
    place of the JAX package's one a layer)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-0.6b", "--shape", "decode_32k", "--mesh", "pod", "--out",
         str(tmp_path)], capture_output=True, text=True, timeout=600,
        env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(
        (tmp_path / "qwen3-0.6b__decode_32k__pod__dryrun.json").read_text())
    assert out["ok"] and out["n_chips"] == 256
    mem = out["memory_analysis"]
    assert mem["temp_size_in_bytes"] > 0
    fm = FakeMesh({"data": 16, "model": 16})
    sh = jshapes.SHAPES["decode_32k"]
    jcfg = j_get_config("qwen3-0.6b")
    want = 0
    pshapes = jax.eval_shape(lambda k: j_init_params(jcfg, k),
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
    pspecs = jpart.param_specs(jcfg, pshapes, fm)
    for leaf, spec in zip(jax.tree.leaves(pshapes),
                          jax.tree.leaves(pspecs, is_leaf=lambda x: isinstance(
                              x, jax.sharding.PartitionSpec))):
        want += math.prod(_local_shape(leaf.shape, spec, fm.shape)) \
            * leaf.dtype.itemsize
    want += math.prod(_local_shape((sh.batch, 1), jpart.token_spec(
        fm, sh.batch), fm.shape)) * 4
    jc = jax.eval_shape(lambda: j_init_decode_cache(jcfg, sh.batch, sh.seq))
    fn = jpart.cache_spec(jcfg, fm, sh.batch)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
        if getattr(path[-1], "name", None) == "length":
            want += 4          # the port's one 0-d int32 position
        else:
            want += math.prod(_local_shape(leaf.shape, fn(path, leaf),
                                           fm.shape)) * leaf.dtype.itemsize
    assert mem["argument_size_in_bytes"] == want
    assert mem["alias_size_in_bytes"] > 0
    assert out["cost_analysis"]["flops"] > 0
    assert out["collectives"]["total"] > 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-7b"])
def test_roofline_extrapolation_equals_full_depth(arch):
    """The depth points' affine extrapolation equals the full-depth count
    (the port counts every layer), for a dense and a hybrid id."""
    import torch.distributed as dist
    try:
        res = dryrun.roofline_combo(arch, "long_500k")
        direct = dryrun.lower_combo(arch, "long_500k", False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    roof = res["roofline"]
    assert roof["flops_per_device"] == direct["cost_analysis"]["flops"]
    assert roof["bytes_per_device"] == \
        direct["cost_analysis"]["bytes accessed"]
    assert roof["collective_bytes_per_device"] == \
        direct["collectives"]["total"]
    assert res["depth_points"] == dryrun._depth_points(
        shapes.adapt_config(get_config(arch), shapes.SHAPES["long_500k"]))
