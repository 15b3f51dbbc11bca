"""The training stack of the port (``repro_torch.train``, ``launch/train.py``)
against ``repro.train``.

Mirrors the training-stack tests of ``tests/test_train.py`` on the port
(schedule, loss, loss falling over 80 steps, gradient accumulation,
checkpoint round trip) and holds the port to the JAX package on reduced
``olmo-1b`` (``d_model=128``): ``lr_schedule`` over steps 0-100 bitwise
wherever XLA's and PyTorch's f32 cos agree (2.5e-7 relative where they
round one ulp apart), ``next_token_loss`` at 1e-6, three ``train_step``s from the same
carried-across ``TrainState`` (metrics at 1e-5 relative, every parameter
and moment leaf at 5e-5 absolute: f32 sums in other orders through two
layers and three AdamW steps), and microbatching at 5e-5. The per-id
train smoke of ``tests/test_configs_smoke.py`` runs on all 11 ids, with
the port's gradients held to ``jax.value_and_grad`` of the same loss at
1e-4 of each leaf's largest |g|. Checkpoints restore bitwise in both
directions between the packages (bf16 leaves included), and the
package's MessagePack codec writes the bytes ``msgpack`` writes.
"""
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import train as jtrain
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.data import DataConfig, SyntheticTokens
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import reduced as j_reduced
from repro_torch import train
from repro_torch.compat import cap_xdist_threads
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import _cuda
from repro_torch.launch import train as train_launch
from repro_torch.models import forward, init_params, reduced
from repro_torch.models import transformer
from repro_torch.train import _msgpack
from repro_torch.train.tree import tree_items, tree_leaves, tree_unflatten
from repro_torch.weights import from_jax_params, train_state_from_jax

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

STEP_RTOL = 1e-5      # loss, grad_norm, lr after each step
LEAF_ATOL = 5e-5      # every parameter and moment leaf after three steps
GRAD_TOL = 1e-4       # of each leaf's largest |g| (the per-id smoke)


@pytest.fixture(scope="module")
def cfgs():
    return (j_reduced(j_get_config("olmo-1b"), d_model=128),
            reduced(get_config("olmo-1b"), d_model=128))


@pytest.fixture(scope="module")
def data(cfgs):
    return SyntheticTokens(DataConfig(vocab_size=cfgs[0].vocab_size,
                                      seq_len=32, batch_size=4, seed=0))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _bits(t) -> np.ndarray:
    """A leaf's raw bits: bf16 as int16, the rest as they are."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# --------------------------------------------------------------- schedule
def test_lr_schedule_shape():
    c = train.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(train.lr_schedule(c, s)) for s in range(0, 101, 10)]
    assert lrs[0] == 0.0 or lrs[0] < 1e-3 / 5
    assert max(lrs) == pytest.approx(1e-3, rel=1e-6)
    assert lrs[-1] == pytest.approx(1e-4, rel=1e-3)
    assert all(a >= b - 1e-12 for a, b in zip(lrs[1:], lrs[2:]))


def test_lr_schedule_matches_reference():
    c = train.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jc = jtrain.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    steps = np.arange(101, dtype=np.int32)
    got = train.lr_schedule(c, torch.from_numpy(steps)).numpy()
    want = np.asarray(jtrain.lr_schedule(jc, jnp.asarray(steps)))
    assert got.dtype == want.dtype == np.float32
    # XLA's and PyTorch's f32 cos round 5 of these 101 arguments one ulp
    # apart; where the decay's 1 + cos nears 0 (steps 80, 82, 98) that is
    # 2.2e-7 of the rate (measured). Wherever the two cos agree the
    # schedule agrees bitwise
    t = np.clip((steps - 10) / np.float32(90), 0, 1).astype(np.float32)
    arg = (np.float32(np.pi) * t).astype(np.float32)
    same_cos = (torch.cos(torch.from_numpy(arg)).numpy()
                == np.asarray(jnp.cos(jnp.asarray(arg))))
    assert (~same_cos).sum() <= 5
    np.testing.assert_array_equal(got[same_cos], want[same_cos])
    np.testing.assert_allclose(got[~same_cos], want[~same_cos], rtol=2.5e-7,
                               atol=0)


# ------------------------------------------------------------------- loss
def test_next_token_loss_exact():
    loss = train.next_token_loss(torch.zeros(1, 3, 5),
                                 torch.tensor([[1, 2, 3]]))
    assert float(loss) == pytest.approx(np.log(5.0), rel=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_next_token_loss_matches_reference(masked):
    rng = np.random.default_rng(3)
    logits = (3.0 * rng.normal(size=(3, 9, 40))).astype(np.float32)
    tokens = rng.integers(0, 40, size=(3, 9)).astype(np.int32)
    mask = (rng.random((3, 9)) < 0.6).astype(np.float32) if masked else None
    got = train.next_token_loss(
        torch.from_numpy(logits), torch.from_numpy(tokens),
        None if mask is None else torch.from_numpy(mask))
    want = jtrain.next_token_loss(jnp.asarray(logits), jnp.asarray(tokens),
                                  None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- training
def test_training_reduces_loss(cfgs, data):
    """80 optimizer steps on the structured stream cut the loss well below
    the uniform baseline (``test_train.py``'s bounds)."""
    _, cfg = cfgs
    step_fn = train.make_train_step(cfg, train.AdamWConfig(
        lr=3e-3, warmup_steps=10, total_steps=150, weight_decay=0.0))
    state = train.init_train_state(cfg, seed=0, device="cpu")
    losses = []
    for i in range(80):
        state, metrics = step_fn(state, {"tokens": data.batch(i)["tokens"]})
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert min(losses[-5:]) < losses[0] * 0.75, (losses[0], losses[-1])
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 1.0


def _carried(jcfg, seed):
    js = jtrain.init_train_state(jcfg, jax.random.PRNGKey(seed))
    return js, train_state_from_jax(jax.device_get(js), device="cpu")


def _clone(state):
    return tree_unflatten(state, [t.clone() for t in tree_leaves(state)])


def test_three_steps_match_reference(cfgs, data):
    """Three steps from the same state on the same batches: metrics at
    1e-5 relative, every leaf (parameters, m, v; the step exactly) at
    5e-5; the argument's tensors untouched."""
    jcfg, cfg = cfgs
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=150)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jtrain.AdamWConfig(**kw)))
    step = train.make_train_step(cfg, train.AdamWConfig(**kw))
    js, ps = _carried(jcfg, 0)
    for i in range(3):
        batch = data.batch(i)["tokens"]
        js, jm = jstep(js, {"tokens": jnp.asarray(batch)})
        before = _clone(ps)
        new, pm = step(ps, {"tokens": batch})
        for a, b in zip(tree_leaves(before), tree_leaves(ps)):
            assert torch.equal(a, b)                 # functional update
        ps = new
        for k in ("loss", "total_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=STEP_RTOL, err_msg=k)
    jleaves = jax.tree.leaves(jax.device_get(js))
    items = tree_items(ps)
    assert len(jleaves) == len(items)
    for (path, got), want in zip(items, jleaves):
        assert tuple(got.shape) == np.shape(want), path
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=LEAF_ATOL, err_msg=path)
    assert int(ps.opt.step) == 3 and ps.opt.step.dtype == torch.int32


def test_grad_accumulation_matches_full_batch(cfgs, data):
    """Microbatch 2 against the full batch (5e-5), and against the JAX
    package's microbatched step."""
    jcfg, cfg = cfgs
    kw = dict(lr=1e-3, grad_clip=1e9, weight_decay=0.0)
    full = train.make_train_step(cfg, train.AdamWConfig(**kw))
    micro = train.make_train_step(cfg, train.AdamWConfig(**kw), microbatch=2)
    jmicro = jax.jit(jtrain.make_train_step(jcfg, jtrain.AdamWConfig(**kw),
                                            microbatch=2))
    js0, s0 = _carried(jcfg, 1)
    batch = data.batch(0)["tokens"]
    s1, m1 = full(s0, {"tokens": batch})
    s2, m2 = micro(s0, {"tokens": batch})
    js2, jm2 = jmicro(js0, {"tokens": jnp.asarray(batch)})
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    assert float(m2["loss"]) == pytest.approx(float(jm2["loss"]), rel=1e-5)
    d = max(float((a.float() - b.float()).abs().max())
            for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)))
    assert d < 5e-5
    for got, want in zip(tree_leaves(s2), jax.tree.leaves(
            jax.device_get(js2))):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=LEAF_ATOL)


def test_microbatch_drops_the_remainder(cfgs, data):
    """B 4 at microbatch 3: one chunk of 3 rows, the fourth row dropped, as
    in the JAX package."""
    _, cfg = cfgs
    opt = train.AdamWConfig(lr=1e-3)
    s0 = train.init_train_state(cfg, seed=2, device="cpu")
    batch = data.batch(0)["tokens"]
    _, m3 = train.make_train_step(cfg, opt, microbatch=3)(
        s0, {"tokens": batch})
    _, mf = train.make_train_step(cfg, opt)(s0, {"tokens": batch[:3]})
    assert float(m3["loss"]) == pytest.approx(float(mf["loss"]), rel=1e-6)


def test_prefix_train_step_matches_reference():
    """A train step of reduced llava with its prefix embeddings (the
    trainer's ``prefix_embeds``; their logits are discarded)."""
    jcfg = j_reduced(j_get_config("llava-next-mistral-7b"), d_model=128)
    cfg = reduced(get_config("llava-next-mistral-7b"), d_model=128)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    pe = (0.1 * rng.normal(size=(2, cfg.n_prefix_embeds, cfg.d_model))) \
        .astype(np.float32)
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=150)
    js, ps = _carried(jcfg, 4)
    js, jm = jax.jit(jtrain.make_train_step(jcfg, jtrain.AdamWConfig(**kw)))(
        js, {"tokens": jnp.asarray(tokens), "prefix_embeds": jnp.asarray(pe)})
    ps, pm = train.make_train_step(cfg, train.AdamWConfig(**kw))(
        ps, {"tokens": tokens, "prefix_embeds": pe})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                   rtol=STEP_RTOL, err_msg=k)
    for got, want in zip(tree_leaves(ps), jax.tree.leaves(
            jax.device_get(js))):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=LEAF_ATOL)


# -------------------------------------------------- per-id train smoke
def _smoke_loss(cfg, params, toks, pe, S):
    """``test_smoke_train_step``'s loss: mean next-token NLL over the
    text positions plus the MoE aux loss."""
    out = forward(cfg, params, toks[:, :-1], prefix_embeds=pe,
                  force_ref=True)
    logp = torch.log_softmax(out.logits[:, -S:, :].float(), dim=-1)
    nll = -torch.gather(logp, -1, toks[:, 1:, None].long()).mean()
    return nll + out.aux_loss


def test_every_reference_id_is_trained():
    assert set(ARCH_IDS) == set(J_ARCH_IDS)


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_smoke_train_step(arch):
    """One step on each reduced id: finite loss and gradients, gradients
    equal to ``jax.value_and_grad`` of the reference's loss at 1e-4 of
    each leaf's largest |g|, a finite loss after an SGD step."""
    jcfg = j_reduced(j_get_config(arch))
    cfg = reduced(get_config(arch))
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.device_get(jparams), device="cpu")
    B, S = 2, 16
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    pe = None
    if cfg.n_prefix_embeds:
        pe = (0.1 * rng.normal(size=(B, cfg.n_prefix_embeds, cfg.d_model))) \
            .astype(np.float32)

    def j_loss(p):
        out = j_forward(jcfg, p, jnp.asarray(toks)[:, :-1],
                        prefix_embeds=None if pe is None
                        else jnp.asarray(pe))
        logits = out.logits[:, -S:, :].astype(jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(toks)[:, 1:, None],
                                   axis=-1).mean()
        return nll + out.aux_loss

    jl, jg = jax.value_and_grad(j_loss)(jparams)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    pe_t = None if pe is None else torch.from_numpy(pe)
    loss = _smoke_loss(cfg, p, torch.from_numpy(toks), pe_t, S)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    loss = loss.detach()
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads
                           if g is not None))
    assert np.isfinite(float(gnorm)) and float(gnorm) > 0
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for (path, _), g, want in zip(tree_items(params), grads, jleaves):
        want = np.asarray(want, np.float32)
        got = np.zeros_like(want) if g is None else _np(g)
        scale = float(np.abs(want).max())
        assert np.abs(got - want).max() <= GRAD_TOL * max(scale, 1e-30), \
            (path, float(np.abs(got - want).max()), scale)
    with torch.no_grad():
        moved = tree_unflatten(params, [
            t - 1e-3 * (torch.zeros_like(t) if g is None else g)
            for t, g in zip(leaves, grads)])
        assert np.isfinite(float(_smoke_loss(cfg, moved,
                                             torch.from_numpy(toks), pe_t,
                                             S)))


# ------------------------------------------------------------------ remat
def _grads(cfg, params, tokens, pe=None):
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    loss = _smoke_loss(cfg, p, tokens, pe, tokens.shape[1] - 1)
    return loss, torch.autograd.grad(loss, leaves, allow_unused=True)


def _saved_tensors(cfg, params, tokens) -> int:
    n = 0

    def pack(t):
        nonlocal n
        n += 1
        return t
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        _smoke_loss(cfg, tree_unflatten(params, leaves), tokens, None,
                    tokens.shape[1] - 1)
    return n


@pytest.mark.parametrize("arch,kw", [
    ("olmo-1b", {}),
    ("musicgen-medium", {}),
    ("zamba2-7b", {"n_layers": 5}),
    ("zamba2-7b", {"n_layers": 5, "remat_group": True}),
], ids=["olmo", "musicgen", "zamba2", "zamba2-group"])
def test_remat_gradients_bitwise(arch, kw):
    """Activation checkpointing changes no bit of the loss or the
    gradients on the CPU, and saves fewer tensors for the backward pass."""
    base = reduced(get_config(arch), d_model=128)
    extra = {"attn_every": 2} if arch == "zamba2-7b" else {}
    plain = dataclasses.replace(base, **extra, **{
        k: v for k, v in kw.items() if k != "remat_group"})
    rem = dataclasses.replace(plain, remat=True,
                              remat_group=kw.get("remat_group", False))
    params = init_params(plain, seed=1, device="cpu")
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, plain.vocab_size, (2, 13)))
    pe = None
    if plain.n_prefix_embeds:
        pe = torch.from_numpy((0.1 * rng.normal(
            size=(2, plain.n_prefix_embeds, plain.d_model))).astype(
                np.float32))
    l0, g0 = _grads(plain, params, tokens, pe)
    l1, g1 = _grads(rem, params, tokens, pe)
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert _saved_tensors(rem, params, tokens) \
        < _saved_tensors(plain, params, tokens)


def test_remat_costs_nothing_without_grad():
    """Serving parameters require no grad: a remat config's forward runs
    as is (no checkpoint), with the same logits, with grad mode on or
    off."""
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b")), remat=True)
    params = init_params(cfg, seed=0, device="cpu")
    tokens = torch.ones(1, 7, dtype=torch.long)
    x = torch.zeros(1, 7, cfg.d_model)
    assert not transformer._records_grad(params, x)
    want = forward(dataclasses.replace(cfg, remat=False), params,
                   tokens).logits
    for ctx in (torch.enable_grad, torch.no_grad, torch.inference_mode):
        with ctx():
            got = forward(cfg, params, tokens).logits
        assert torch.equal(got, want)
        assert got.grad_fn is None


# ------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip(cfgs, tmp_path):
    _, cfg = cfgs
    state = train.init_train_state(cfg, seed=2, device="cpu")
    train.save_checkpoint(str(tmp_path / "ck"), state, step=7)
    assert train.checkpoint_step(str(tmp_path / "ck")) == 7
    assert train.checkpoint_step(str(tmp_path / "none")) is None
    like = train.init_train_state(cfg, seed=3, device="cpu")
    restored = train.restore_checkpoint(str(tmp_path / "ck"), like)
    assert type(restored) is train.TrainState
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    assert meta["treedef"][0] == "params/blocks/attn/wk"
    assert meta["treedef"][-1] == "opt/step"


def _bf16_states(seed):
    jcfg = dataclasses.replace(j_reduced(j_get_config("olmo-1b"),
                                         d_model=128), dtype="bfloat16")
    js = jtrain.init_train_state(jcfg, jax.random.PRNGKey(seed))
    return js, train_state_from_jax(jax.device_get(js), device="cpu")


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A checkpoint the JAX package writes (bf16 parameters, f32 moments,
    an int32 step) restores in the port bitwise, leaf for leaf."""
    js, _ = _bf16_states(0)
    js = js._replace(opt=js.opt._replace(step=jnp.asarray(5, jnp.int32)))
    jtrain.save_checkpoint(str(tmp_path / "ck"), js, step=5)
    _, like = _bf16_states(1)
    got = train.restore_checkpoint(str(tmp_path / "ck"), like)
    assert train.checkpoint_step(str(tmp_path / "ck")) == 5
    dtypes = set()
    for a, want in zip(tree_leaves(got), jax.tree.leaves(
            jax.device_get(js))):
        dtypes.add(a.dtype)
        np.testing.assert_array_equal(_bits(a), _bits(want))
    assert dtypes == {torch.bfloat16, torch.float32, torch.int32}


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    _, ps = _bf16_states(0)
    ps = ps._replace(opt=ps.opt._replace(
        step=torch.tensor(9, dtype=torch.int32)))
    train.save_checkpoint(str(tmp_path / "ck"), ps, step=9)
    like, _ = _bf16_states(1)
    got = jtrain.restore_checkpoint(str(tmp_path / "ck"), like)
    assert jtrain.checkpoint_step(str(tmp_path / "ck")) == 9
    for want, a in zip(tree_leaves(ps), jax.tree.leaves(
            jax.device_get(got))):
        assert np.asarray(a).dtype.name == str(want.dtype).split(".")[-1]
        np.testing.assert_array_equal(_bits(a), _bits(want))


def test_restore_refuses_other_structures(cfgs, tmp_path):
    _, cfg = cfgs
    state = train.init_train_state(cfg, seed=0, device="cpu")
    train.save_checkpoint(str(tmp_path / "ck"), state)
    with pytest.raises(ValueError, match="leaves; target structure"):
        train.restore_checkpoint(str(tmp_path / "ck"), state.params)
    wide = train.init_train_state(
        dataclasses.replace(cfg, d_ff=cfg.d_ff * 2), seed=0, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        train.restore_checkpoint(str(tmp_path / "ck"), wide)


@pytest.fixture
def deterministic():
    """PyTorch's deterministic algorithms: the embedding's backward
    (an accumulating index_put_) otherwise sums its rows in a
    thread-dependent order, so two runs of the same step can differ in
    the last bits with or without a checkpoint between them."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def test_resume_is_bitwise(cfgs, data, tmp_path, deterministic):
    """4 steps, save, restore into a fresh state, 4 more: the same losses
    and state, bit for bit, as 8 steps uninterrupted."""
    _, cfg = cfgs
    step = train.make_train_step(cfg, train.AdamWConfig(
        lr=3e-3, warmup_steps=5, total_steps=8))
    state = train.init_train_state(cfg, seed=0, device="cpu")
    straight, resumed = [], []
    s = state
    for i in range(8):
        s, m = step(s, {"tokens": data.batch(i)["tokens"]})
        straight.append(float(m["loss"]))
    r = state
    for i in range(4):
        r, m = step(r, {"tokens": data.batch(i)["tokens"]})
        resumed.append(float(m["loss"]))
    train.save_checkpoint(str(tmp_path / "ck"), r, step=4)
    r = train.restore_checkpoint(str(tmp_path / "ck"), train.init_train_state(
        cfg, seed=9, device="cpu"))
    for i in range(4, 8):
        r, m = step(r, {"tokens": data.batch(i)["tokens"]})
        resumed.append(float(m["loss"]))
    assert resumed == straight
    for a, b in zip(tree_leaves(s), tree_leaves(r)):
        assert torch.equal(a, b)


def test_tree_order_is_jax_flatten_order():
    tree = {"b": {"y": 1, "x": 2}, "a": (3, None, {}), "c": {"z": [4, 5]}}
    assert tree_leaves(tree) == jax.tree.leaves(tree) == [3, 2, 1, 4, 5]
    assert [k for k, _ in tree_items(tree)] == [
        "a/0", "b/x", "b/y", "c/z/0", "c/z/1"]
    back = tree_unflatten(tree, [30, 20, 10, 40, 50])
    assert back == {"b": {"y": 10, "x": 20}, "a": (30, None, {}),
                    "c": {"z": [40, 50]}}
    opt = train.OptState(m={"w": 1}, v={"w": 2}, step=3)
    assert tree_leaves(train.TrainState(params={"w": 0}, opt=opt)) \
        == [0, 1, 2, 3]


# ------------------------------------------------------------------ codec
_INTS = (0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
         2 ** 64 - 1)
_LENS = (0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536)


def _random_map(rng):
    def value(depth):
        kind = rng.integers(0, 5 if depth < 2 else 4)
        n = _LENS[rng.integers(len(_LENS))]
        if kind == 0:
            return _INTS[rng.integers(len(_INTS))] if rng.random() < 0.5 \
                else int(rng.integers(0, 2 ** 62))
        if kind == 1:
            return "".join(rng.choice(list("abcé✓xyz"), size=min(n, 400)))
        if kind == 2:
            return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        if kind == 3:
            return [_INTS[i] for i in rng.integers(len(_INTS),
                                                    size=min(n, 70000))]
        return {f"k{i}": value(depth + 1)
                for i in range(int(rng.integers(0, 20)))}
    return {f"key{i}" * int(rng.integers(1, 12)): value(0)
            for i in range(int(rng.integers(1, 18)))}


@pytest.mark.parametrize("seed", range(6))
def test_codec_matches_msgpack(seed, tmp_path):
    """``packb`` writes the bytes ``msgpack.packb(use_bin_type=True)``
    writes; ``unpack_stream`` reads a file of concatenated objects as
    ``msgpack.Unpacker(raw=False)`` does."""
    rng = np.random.default_rng(seed)
    objs = [_random_map(rng) for _ in range(4)]
    objs.append({"i": 3, "dtype": "bfloat16", "shape": [2, 70000],
                 "data": bytes(range(256)) * 3})
    for obj in objs:
        assert _msgpack.packb(obj) == msgpack.packb(obj, use_bin_type=True)
    path = tmp_path / "s.msgpack"
    path.write_bytes(b"".join(msgpack.packb(o, use_bin_type=True)
                              for o in objs))
    with open(path, "rb") as f:
        assert list(_msgpack.unpack_stream(f)) == objs
    with pytest.raises(ValueError, match="outside the subset"):
        _msgpack.packb({"n": -1})


# -------------------------------------------------------------- grad guard
def test_refuse_grad_on_cpu_tensors():
    """The guard every kernel wrapper's CUDA branch calls: it raises when
    autograd would record through a kernel, and passes otherwise."""
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(3)
    with pytest.raises(RuntimeError, match="fused_ffn.*forward-only"):
        _cuda.refuse_grad("fused_ffn", (y, None, x))
    _cuda.refuse_grad("fused_ffn", (y, None))
    with torch.no_grad():
        _cuda.refuse_grad("fused_ffn", (x,))
    with torch.inference_mode():
        _cuda.refuse_grad("fused_ffn", (x,))


# ----------------------------------------------------------------- launch
def test_train_driver_reduced(tmp_path, capsys):
    """``test_launch_drivers.py``'s train driver test on the port, then a
    resume from the checkpoint it left."""
    ck = str(tmp_path / "ck")
    args = ["--arch", "olmo-1b", "--reduced", "--batch", "2", "--seq", "32",
            "--ckpt", ck, "--ckpt-every", "4", "--device", "cpu"]
    log = train_launch.main(args + ["--steps", "8"])
    out = capsys.readouterr().out
    assert "step     7" in out and out.rstrip().endswith("done")
    assert (tmp_path / "ck" / "meta.json").exists()
    assert train.checkpoint_step(ck) == 8
    assert log["start_step"] == 0 and len(log["loss"]) == 8
    assert np.isfinite(log["loss"]).all()
    log = train_launch.main(args + ["--steps", "10", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "resumed from step 8" in out and "step     9" in out
    assert "step     7" not in out
    assert log["start_step"] == 8 and len(log["loss"]) == 2
    assert train.checkpoint_step(ck) == 10
    shutil.rmtree(ck)
