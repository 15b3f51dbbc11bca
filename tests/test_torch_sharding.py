"""The distribution layer of the port against the JAX package's.

* Partition rules: ``param_specs``, ``cache_spec`` and ``token_spec`` give
  the JAX package's specs leaf for leaf, as tuples, for all 11 ids on the
  production meshes (16, 16) and (2, 16, 16) under each
  ``ShardingOptions`` flag (a stand-in mesh, as ``tests/test_sharding.py``
  uses; shapes only), and every spec divides its dimension.
* Sharded runs on a 2x2 gloo mesh of four CPU processes (spawned inside
  a subprocess, as the JAX package's sharding tests run theirs): the
  sharded train step's loss and the sharded decode step's logits against
  the unsharded port run (1e-5; the scan families also at S 200, their
  chunked scans over 25 chunks), the loss against the JAX package's
  unsharded train step on the same numpy parameters (1e-5), both MoE
  dispatches against the local one and the JAX ``_moe_local`` (1e-5, the
  bar of ``tests/test_moe_ep.py``), a checkpoint restored into a sharded
  ``TrainState`` bitwise the unsharded restore, and every kernel wrapper
  refusing a DTensor.
"""
import functools
import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.launch.shapes import SHAPES as J_SHAPES
from repro.launch.shapes import adapt_config as j_adapt_config
from repro.models import forward as j_forward
from repro.models import init_decode_cache as j_init_decode_cache
from repro.models import init_params as j_init_params
from repro.models import moe as j_moe
from repro.models import reduced as j_reduced
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro.sharding import partition as jpart
from repro.train import next_token_loss as j_next_token_loss
from repro_torch.compat import cap_xdist_threads
from repro_torch.configs import get_config
from repro_torch.launch.shapes import SHAPES, input_specs, params_specs_for
from repro_torch.sharding import partition as part

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeMesh:
    """The production meshes' axis sizes, as ``tests/test_sharding.py``
    stands in for them."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"pod": FakeMesh({"data": 16, "model": 16}),
          "multipod": FakeMesh({"pod": 2, "data": 16, "model": 16})}
FLAGS = ({}, {"expert_parallel": True}, {"seq_sharded_cache": True},
         {"zero_optimizer": True})


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", "?"))))


def _j_specs(tree) -> dict:
    """path -> tuple(spec) of a JAX tree of PartitionSpecs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(_key(k) for k in path): tuple(s) for path, s in flat}


def _p_specs(tree) -> dict:
    """path -> tuple(spec) of the port's tree of specs."""
    out = {}

    def walk(node, path):
        if isinstance(node, part.P):
            out[path] = tuple(node)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for f, v in zip(node._fields, node):
                walk(v, path + (f,))
    walk(tree, ())
    return out


@functools.lru_cache(maxsize=None)
def _j_param_shapes(arch):
    cfg = j_get_config(arch)
    return jax.eval_shape(lambda k: j_init_params(cfg, k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


@functools.lru_cache(maxsize=None)
def _p_params(arch):
    return params_specs_for(get_config(arch), None)[0]


# ------------------------------------------------------------- spec parity
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh):
    m = MESHES[mesh]
    for flags in FLAGS:
        want = _j_specs(jpart.param_specs(
            j_get_config(arch), _j_param_shapes(arch), m,
            jpart.ShardingOptions(**flags)))
        got = _p_specs(part.param_specs(get_config(arch), _p_params(arch), m,
                                        part.ShardingOptions(**flags)))
        assert got == want, (arch, mesh, flags)


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch, shape):
    """Every cache leaf's spec, both meshes, each flag. The port's KV
    caches hold one 0-d ``length`` (the JAX package one a layer) and its
    recurrent caches a host int: those specs replicate on both sides."""
    sh = J_SHAPES[shape]
    jcfg = j_adapt_config(j_get_config(arch), sh)
    jshapes = jax.eval_shape(lambda: j_init_decode_cache(jcfg, sh.batch,
                                                         sh.seq))
    spec = input_specs(get_config(arch), SHAPES[shape], None)
    cache, cfg = spec["cache"], spec["cfg"]
    assert cfg.sliding_window == jcfg.sliding_window
    for name, m in MESHES.items():
        for flags in FLAGS:
            want = _j_specs(jax.tree_util.tree_map_with_path(
                jpart.cache_spec(jcfg, m, sh.batch,
                                 jpart.ShardingOptions(**flags)), jshapes))
            got = _p_specs(part.tree_map_with_path(
                part.cache_spec(cfg, m, sh.batch,
                                part.ShardingOptions(**flags)), cache))
            for path, s in want.items():
                if path[-1] == "length":
                    assert all(e is None for e in s), path
                    assert all(e is None for e in got.get(path, ())), path
                else:
                    assert got[path] == s, (name, flags, path)
            assert set(got) <= set(want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_token_spec_matches_reference(mesh):
    m = MESHES[mesh]
    for sh in SHAPES.values():
        for batch in (sh.batch, 1, 3, 512):
            assert tuple(part.token_spec(m, batch)) == \
                tuple(jpart.token_spec(m, batch))
    assert part.batch_axes(m) == jpart.batch_axes(m)


def test_partition_rules_divisibility():
    """Every generated spec must divide the corresponding dim (all archs,
    production mesh shape) — the rule that caught granite's vocab."""
    m = MESHES["pod"]
    for arch in ARCH_IDS:
        params = _p_params(arch)
        specs = part.param_specs(get_config(arch), params, m)
        leaves = []
        part.tree_map2(lambda t, s: leaves.append((t, s)), params, specs)
        assert leaves
        for leaf, spec in leaves:
            for dim, ax in zip(leaf.shape, tuple(spec)):
                if ax is None:
                    continue
                axes = ax if isinstance(ax, tuple) else (ax,)
                n = int(np.prod([m.shape[a] for a in axes]))
                assert dim % n == 0, (arch, tuple(leaf.shape), spec)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:   # placements read the axis order only
        mesh_dim_names = ("pod", "data", "model")

    got = part.placements(part.P(("pod", "data"), None, "model"), Mesh())
    assert got == (Shard(0), Shard(0), Shard(2))
    assert part.placements(part.P(), Mesh()) == (Replicate(),) * 3
    assert part.P(("data",), None) == ("data", None)


# ------------------------------------------------------ sharded gloo runs
ARCH_PAIRS = ["qwen3-0.6b,rwkv6-1.6b", "deepseek-moe-16b,zamba2-7b",
              "starcoder2-3b,musicgen-medium"]
RUN_ARCHS = [a for pair in ARCH_PAIRS for a in pair.split(",")]
B, S = 4, 16
SCAN_ARCHS = ("rwkv6-1.6b", "zamba2-7b")
LONG_S = 200              # both scans' chunked math at 25 chunks of 8

EP_CFG = dict(arch_id="t", family="moe", n_layers=1, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab_size=97, dtype="float32")
EP_MOE = dict(n_experts=8, top_k=2, n_shared_experts=1, d_expert=16,
              impl="capacity", capacity_factor=8.0)

SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, pickle, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def full(t):
        from torch.distributed.tensor import DTensor
        return t.full_tensor() if isinstance(t, DTensor) else t

    def worker(rank, tmp):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=rank, world_size=4)
        from repro_torch.configs import get_config
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.models import (decode_step, init_decode_cache,
                                        reduced)
        from repro_torch.models import moe as M
        from repro_torch.models.config import ModelConfig, MoEConfig
        from repro_torch.sharding import partition as part
        from repro_torch.sharding.context import use_mesh
        from repro_torch.train import (AdamWConfig, TrainState,
                                       init_opt_state, make_train_step,
                                       restore_checkpoint, save_checkpoint)
        from repro_torch.train.tree import tree_leaves
        from repro_torch.weights import from_jax_params
        from chip_smoke import train_state_delta

        inp = pickle.load(open(f"{tmp}/inputs.pkl", "rb"))
        B = inp["B"]
        mesh = make_debug_mesh(2, 2)
        res = {"archs": {}}
        tok_pl = part.placements(part.token_spec(mesh, B), mesh)
        for arch, d in inp["archs"].items():
            cfg = reduced(get_config(arch))
            params = from_jax_params(d["params"], "cpu")
            toks = torch.from_numpy(d["tokens"])
            step = make_train_step(cfg, AdamWConfig(lr=1e-3))
            st, m = step(TrainState(params, init_opt_state(params)),
                         {"tokens": toks})
            tok = torch.zeros(B, 1, dtype=torch.int32)
            want = decode_step(cfg, params, tok,
                               init_decode_cache(cfg, B, 32, "cpu"),
                               force_ref=True).logits
            with use_mesh(mesh):
                dp = part.distribute(
                    params, part.param_placements(cfg, params, mesh), mesh)
                dst, dm = step(TrainState(dp, init_opt_state(dp)),
                               {"tokens": part.distribute(toks, tok_pl,
                                                          mesh)})
                cache = init_decode_cache(cfg, B, 32, "cpu")
                dc = part.distribute(cache, part.cache_placements(
                    cfg, cache, mesh, B), mesh)
                got = full(decode_step(
                    cfg, dp, part.distribute(tok, tok_pl, mesh), dc,
                    force_ref=True).logits)
                sharded_loss = float(full(dm["loss"]))
                kept = all(a.placements == b.placements for a, b in
                           zip(tree_leaves(dst), tree_leaves(TrainState(
                               dp, init_opt_state(dp))))
                           if hasattr(a, "placements"))
            scfg, sst, sdst = cfg, st, dst
            if cfg.family == "moe":
                # the sharded aux loss is the mean of the data shards'
                # (the JAX package's pmean), not the whole batch's: the
                # new states are compared on a step without it
                scfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, router_aux_coef=0.0))
                sstep = make_train_step(scfg, AdamWConfig(lr=1e-3))
                sst, _ = sstep(TrainState(params, init_opt_state(params)),
                               {"tokens": toks})
                with use_mesh(mesh):
                    sdst, _ = sstep(TrainState(dp, init_opt_state(dp)),
                                    {"tokens": part.distribute(
                                        toks, tok_pl, mesh)})
            res["archs"][arch] = {
                "loss": float(m["loss"]), "sharded_loss": sharded_loss,
                "grad_norm": float(m["grad_norm"]),
                "sharded_grad_norm": float(full(dm["grad_norm"])),
                "moe": cfg.family == "moe", "placements_kept": kept,
                "state": train_state_delta(sdst, sst, params,
                                           float(m["lr"]),
                                           AdamWConfig(lr=1e-3)),
                "decode_diff": float((got - want).abs().max()),
                "finite": bool(torch.isfinite(got).all()),
                "sharded_cache": any(
                    not p.is_replicate()
                    for t in tree_leaves(dc) if hasattr(t, "placements")
                    for p in t.placements)}
            if "long_tokens" in d:
                # the scans' chunked math over several chunks (S 200: 25
                # chunks of 8 in both scans), sharded against unsharded
                lt = torch.from_numpy(d["long_tokens"])
                _, lm = step(TrainState(params, init_opt_state(params)),
                             {"tokens": lt})
                with use_mesh(mesh):
                    _, ldm = step(TrainState(dp, init_opt_state(dp)),
                                  {"tokens": part.distribute(lt, tok_pl,
                                                             mesh)})
                res["archs"][arch]["long"] = {
                    "S": lt.shape[1] - 1, "loss": float(lm["loss"]),
                    "sharded_loss": float(full(ldm["loss"])),
                    "grad_norm": float(lm["grad_norm"]),
                    "sharded_grad_norm": float(full(ldm["grad_norm"]))}
            if arch == inp["ckpt_arch"]:
                ck = f"{tmp}/ckpt"
                if rank == 0:
                    save_checkpoint(ck, st, step=1)
                dist.barrier()
                plain = restore_checkpoint(ck, st)
                with use_mesh(mesh):
                    like = TrainState(dp, init_opt_state(dp))
                    sharded = restore_checkpoint(ck, like)
                a, b = tree_leaves(plain), tree_leaves(sharded)
                res["ckpt"] = {
                    "equal": all(torch.equal(x, full(y))
                                 for x, y in zip(a, b)),
                    "n_leaves": len(a),
                    "n_dtensor": sum(hasattr(y, "placements") for y in b),
                    "placements_kept": all(
                        y.placements == z.placements
                        for y, z in zip(b, tree_leaves(like))
                        if hasattr(y, "placements"))}

        # the MoE's sharded dispatches against the local one
        cfg = ModelConfig(**inp["ep_cfg"], moe=MoEConfig(**inp["ep_moe"]))
        p = from_jax_params(inp["ep_params"], "cpu")
        x = torch.from_numpy(inp["ep_x"])
        y_local, _ = M.moe_forward(cfg, p, x, force_ref=True)
        res["moe"] = {"local_vs_jax": float(
            (y_local - torch.from_numpy(inp["ep_y_jax"])).abs().max())}
        # a decode step's 2 tokens: one a data shard, fewer than the
        # model ranks, whose clamped slices repeat it (dynamic_slice)
        xd = x[:2, :1]
        yd_local, _ = M.moe_forward(cfg, p, xd, force_ref=True)
        for name, ep, xx, want, jax_y in (
                ("hidden", False, x, y_local, inp["ep_y_jax"]),
                ("ep", True, x, y_local, inp["ep_y_jax"]),
                ("ep_decode", True, xd, yd_local, None)):
            opts = part.ShardingOptions(expert_parallel=ep)
            with use_mesh(mesh, opts):
                pl = part.param_placements(cfg, {"moe": p}, mesh,
                                           opts)["moe"]
                y, aux = M.moe_forward(
                    cfg, part.distribute(p, pl, mesh),
                    part.distribute(xx, part.placements(
                        part.P(("data",), None, None), mesh), mesh),
                    force_ref=True)
                y = full(y)
            res["moe"][name] = {
                "vs_local": float((y - want).abs().max()),
                "vs_jax": 0.0 if jax_y is None else float(
                    (y - torch.from_numpy(jax_y)).abs().max())}

        # every kernel wrapper refuses a DTensor
        def dt(*shape):
            return part.distribute(torch.ones(shape), part.placements(
                part.P(), mesh), mesh)
        calls = {
            "flash_attention": lambda: ops.flash_attention(
                dt(1, 4, 2, 8), dt(1, 4, 1, 8), dt(1, 4, 1, 8)),
            "decode_attention": lambda: ops.decode_attention(
                dt(1, 1, 2, 8), dt(1, 4, 1, 8), dt(1, 4, 1, 8),
                part.distribute(torch.ones(1, 4, dtype=torch.bool),
                                part.placements(part.P(), mesh), mesh)),
            "paged_decode_attention": lambda: ops.paged_decode_attention(
                dt(1, 1, 2, 8), dt(2, 4, 1, 8), dt(2, 4, 1, 8),
                torch.zeros(1, 1, dtype=torch.int32),
                torch.zeros(1, dtype=torch.int32)),
            "fused_ffn": lambda: ops.fused_ffn(dt(1, 2, 8), dt(1, 8, 4),
                                               dt(1, 8, 4), dt(1, 4, 8)),
            "rwkv6_scan": lambda: ops.rwkv6_scan(
                dt(1, 2, 1, 4), dt(1, 2, 1, 4), dt(1, 2, 1, 4),
                dt(1, 2, 1, 4), dt(1, 4)),
            "ssd_scan": lambda: ops.ssd_scan(
                dt(1, 2, 1, 4), dt(1, 2, 1), dt(1, 2, 1), dt(1, 2, 4),
                dt(1, 2, 4)),
        }
        res["refused"] = {}
        for name, call in calls.items():
            try:
                call()
                res["refused"][name] = "ran"
            except TypeError as e:
                res["refused"][name] = str(e)
        if rank == 0:
            with open(f"{tmp}/results.json", "w") as f:
                json.dump(res, f)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        tmp = sys.argv[1]
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=worker, args=(r, tmp)) for r in range(4)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(800)
        codes = [p.exitcode for p in procs]
        print("EXITCODES", codes)
        sys.exit(0 if codes == [0, 0, 0, 0] else 1)
""")


def _j_train_loss(jcfg, jparams, toks) -> float:
    """The loss the JAX package's train step reports: its ``loss_fn``'s
    cross-entropy (``repro.train.trainer``), on the step's parameters."""
    S = toks.shape[1] - 1

    def loss(params, tokens):
        logits = j_forward(jcfg, params, tokens[:, :-1]).logits[:, -S:]
        return j_next_token_loss(
            jnp.concatenate([logits, logits[:, -1:]], axis=1), tokens)
    return float(jax.jit(loss)(jparams, jnp.asarray(toks)))


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    """Runs the script on four ranks; the JAX package's train steps run
    here meanwhile."""
    tmp = tmp_path_factory.mktemp("gloo")
    rng = np.random.default_rng(1)
    archs, jax_inputs = {}, {}
    for arch in RUN_ARCHS:
        jcfg = j_reduced(j_get_config(arch))
        jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
        toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
        jax_inputs[arch] = (jcfg, jparams, toks)
        archs[arch] = {"params": jax.device_get(jparams), "tokens": toks}
        if arch in SCAN_ARCHS:
            archs[arch]["long_tokens"] = np.random.default_rng(2).integers(
                0, jcfg.vocab_size, (B, LONG_S + 1)).astype(np.int32)
    jcfg = JModelConfig(**EP_CFG, moe=JMoEConfig(**EP_MOE))
    ep_params = j_moe.init_moe(jcfg, jax.random.PRNGKey(0))
    ep_x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                        (4, 16, 32)) * 0.5, np.float32)
    ep_y, _ = j_moe._moe_local(jcfg, ep_params, jnp.asarray(ep_x))
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({"B": B, "archs": archs, "ckpt_arch": "qwen3-0.6b",
                     "ep_cfg": EP_CFG, "ep_moe": EP_MOE,
                     "ep_params": jax.device_get(ep_params), "ep_x": ep_x,
                     "ep_y_jax": np.asarray(ep_y)}, f)
    script = tmp / "run.py"
    script.write_text(SCRIPT)
    # the repo's root for chip_smoke.train_state_delta, the comparison
    # the card's 1x1 mesh check makes
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    with open(tmp / "stderr.txt", "w") as err:
        proc = subprocess.Popen([sys.executable, str(script), str(tmp)],
                                stdout=subprocess.DEVNULL, stderr=err,
                                env=env, cwd=ROOT)
        try:
            jax_loss = {arch: _j_train_loss(*v)
                        for arch, v in jax_inputs.items()}
            rc = proc.wait(timeout=900)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert rc == 0, (tmp / "stderr.txt").read_text()[-4000:]
    res = json.loads((tmp / "results.json").read_text())
    res["jax_loss"] = jax_loss
    return res


@pytest.mark.parametrize("arch", RUN_ARCHS)
def test_sharded_train_and_decode_on_debug_mesh(arch, gloo_results):
    """Loss and decode logits within 1e-5 of the unsharded port run, the
    loss within 1e-5 of the JAX package's; the gradient's global norm
    within 1e-5 relative, but for a MoE, whose sharded aux loss is the
    mean of the data shards' (the JAX package's pmean), not the whole
    batch's; the new state in the old state's placements. The decode
    step runs on the initial parameters: after one AdamW step a gradient
    element near 0 moves its parameter by up to 2 lr on a rounding."""
    r = gloo_results["archs"][arch]
    assert r["finite"] and r["sharded_cache"], r
    assert abs(r["sharded_loss"] - r["loss"]) <= 1e-5, r
    assert abs(r["loss"] - gloo_results["jax_loss"][arch]) <= 1e-5, \
        (r, gloo_results["jax_loss"][arch])
    assert r["decode_diff"] <= 1e-5, r
    if not r["moe"]:
        assert abs(r["sharded_grad_norm"] - r["grad_norm"]) \
            <= 1e-5 * r["grad_norm"], r
    assert r["placements_kept"], r


@pytest.mark.parametrize("arch", SCAN_ARCHS)
def test_sharded_chunked_scans_match_unsharded(arch, gloo_results):
    """The scan families' train step at S 200 (both chunked scans at 25
    chunks of 8, each rank's batch rows and heads on local shards):
    loss within 1e-5 and gradient norm within 1e-4 relative of the
    unsharded run. The sharded backward sums the heads' and data
    shards' partial gradients in another order; over RWKV6's 200 decayed
    tokens that moves the f32 norm by 1.2e-5 of itself here, and a head
    or a row in the wrong place moves it by its own size."""
    r = gloo_results["archs"][arch]["long"]
    assert r["S"] == LONG_S
    assert abs(r["sharded_loss"] - r["loss"]) <= 1e-5, r
    assert abs(r["sharded_grad_norm"] - r["grad_norm"]) \
        <= 1e-4 * r["grad_norm"], r


@pytest.mark.parametrize("arch", RUN_ARCHS)
def test_sharded_train_state_matches_unsharded(arch, gloo_results):
    """The sharded train step's new state against the unsharded step's
    (the ZeRO and DTensor placements of the moments, ``init_opt_state``'s
    ``zeros_like``, the redistribution into the old placements): the
    moments m and v within 5e-5 of each leaf's norm, the parameters
    nowhere off by more than the 2 lr of a first AdamW step whose sign a
    rounding flips, and the sharded parameters within 1e-2 lr + 1e-6 of
    each leaf's max |p| of the step recomputed from the initial
    parameters and the sharded moments (a wrong sign, rate, bias
    correction or moment moves a parameter by a good share of lr; the
    sharded update divides partial moments, and a bias's data-shard
    partials near-cancel: 1.2e-3 lr at most here). The sharded forward
    sums its contractions in another order; through RWKV's decays that
    moves the moments by up to 4.4e-6 of a leaf's norm (a wrong
    placement moves them by their own size). A MoE's states are compared
    on a step without the aux loss (sharded, it is the mean of the data
    shards')."""
    s = gloo_results["archs"][arch]["state"]
    assert s["m"] <= 5e-5 and s["v"] <= 5e-5, s
    assert s["p_2lr"] <= 1.0 + 1e-6, s
    assert s["p_own"] <= 1.0, s


@pytest.mark.parametrize("dispatch", ["hidden", "ep", "ep_decode"])
def test_sharded_moe_matches_local(dispatch, gloo_results):
    """``_moe_shardmap`` (hidden-sharded experts) and ``_moe_shardmap_ep``
    (experts over ``model``, all-to-all) against the local dispatch and
    the JAX package's ``_moe_local`` ([4, 16] tokens); the expert-parallel
    one also at a decode step's [2, 1], one token a data shard."""
    r = gloo_results["moe"]
    assert r["local_vs_jax"] < 1e-5, r
    assert r[dispatch]["vs_local"] < 1e-5, r
    assert r[dispatch]["vs_jax"] < 1e-5, r


def test_checkpoint_restores_into_sharded_state(gloo_results):
    r = gloo_results["ckpt"]
    assert r["equal"], r
    assert r["n_dtensor"] > 0 and r["placements_kept"], r


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "paged_decode_attention", "fused_ffn",
                                  "rwkv6_scan", "ssd_scan"])
def test_kernel_wrappers_refuse_dtensor(name, gloo_results):
    assert "DTensor" in gloo_results["refused"][name], \
        gloo_results["refused"][name]
