"""The scan families' reference math: the JAX models' chunked SSD and wkv
scans, ported (``models.mamba2.ssd_chunked``, ``models.rwkv6.wkv_chunked``)
as the path of ``force_ref`` (the trainer, the dry-run's counts, the
sharded path).

* The Mamba2 and RWKV6 time-mix layers on ``force_ref`` against the JAX
  functions ``mamba2_forward`` and ``rwkv6_time_mix`` in f32 at rtol = atol
  = 2e-5, at S 16, 37, 113 and 200 (one chunk; the ragged-S halving down
  to one token a chunk; several chunks), output and final state.
* The chunked scans against the sequential oracles (``kernels/ref.py``)
  in f64 at 1e-10, values and gradients by autograd.
* The step counter's FLOPs for a scan layer, forward and backward, equal
  its count of the same layer on the sequential oracle, at two chunk
  lengths.
* Reduced zamba2 and rwkv6 dry-runs of ``train_4k`` and ``prefill_32k`` on
  the production mesh complete, and ``roofline_combo``'s depth
  extrapolation equals the direct full-depth count.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.models import mamba2 as j_mamba2
from repro.models import reduced as j_reduced
from repro.models import rwkv6 as j_rwkv6
from repro_torch.compat import cap_xdist_threads
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.models import init_params, mamba2, reduced, rwkv6
from repro_torch.roofline import analysis
from repro_torch.weights import from_jax_params

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

JAX_TOL = dict(rtol=2e-5, atol=2e-5)
F64_TOL = dict(rtol=1e-10, atol=1e-10)
SEQS = [16, 37, 113, 200]


def _configs(arch: str):
    """(JAX config, port config): reduced rwkv6, or zamba2 reduced to 5
    layers with the shared block every 2 (SSD chunk 32 in both)."""
    if arch == "zamba2-7b":
        return (dataclasses.replace(j_reduced(j_get_config(arch), n_layers=5),
                                    attn_every=2),
                dataclasses.replace(reduced(get_config(arch), n_layers=5),
                                    attn_every=2))
    return j_reduced(j_get_config(arch)), reduced(get_config(arch))


@functools.lru_cache(maxsize=None)
def _layer(arch: str):
    """(JAX config, port config, JAX layer params, port layer params): the
    first recurrent layer of the JAX model's own initialisation."""
    jcfg, cfg = _configs(arch)
    key = "mamba" if arch == "zamba2-7b" else "rwkv"
    jp = jax.tree.map(lambda t: t[0], j_init_params(
        jcfg, jax.random.PRNGKey(4))["blocks"][key])
    return jcfg, cfg, jp, from_jax_params(jax.device_get(jp), device="cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or JAX_TOL))


def test_chunk_len_is_the_jax_rule():
    """min(chunk, S), halved until it divides S."""
    cases = {(16, 32): 16, (37, 32): 1, (113, 32): 1, (200, 32): 8,
             (200, 128): 8, (4096, 256): 256, (96, 128): 96, (100, 64): 4}
    for (S, chunk), Q in cases.items():
        assert mamba2.chunk_len(S, chunk) == Q


@pytest.mark.parametrize("S", SEQS)
def test_ssd_chunked_layer_matches_jax(S):
    jcfg, cfg, jp, p = _layer("zamba2-7b")
    assert cfg.ssm.chunk == jcfg.ssm.chunk == 32
    x = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    want_y, want_c = jax.jit(functools.partial(
        j_mamba2.mamba2_forward, jcfg))(jp, jnp.asarray(x))
    got_y, got_c = mamba2.mamba2_forward(cfg, p, torch.from_numpy(x),
                                         force_ref=True)
    _close(got_y, want_y)
    for name in ("conv_x", "conv_bc", "ssd"):
        _close(getattr(got_c, name), getattr(want_c, name))


@pytest.mark.parametrize("S", SEQS)
def test_wkv_chunked_layer_matches_jax(S):
    jcfg, cfg, jp, p = _layer("rwkv6-1.6b")
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    prev = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    want = jax.jit(functools.partial(j_rwkv6.rwkv6_time_mix, jcfg))(
        jp, jnp.asarray(x), jnp.asarray(prev))
    got = rwkv6.rwkv6_time_mix(cfg, p, torch.from_numpy(x),
                               torch.from_numpy(prev), force_ref=True)
    for g, w in zip(got, want):               # y, final state, last token
        _close(g, w)


def _scan_inputs(name: str, S: int, rng):
    """f64 inputs of a scan in the model layout, from a numpy seed: the
    SSD's x [B,S,nh,hd], dt = softplus(N - 2), la = -dt, B and C rows;
    the wkv's r, k, v, decays -exp(1.5 N - 2) (down to ~-12 a token) and
    the bonus u."""
    def n(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale)
    B, nh, hd, ds = 2, 3, 8, 4
    if name == "ssd":
        dt = torch.nn.functional.softplus(n(B, S, nh) - 2.0)
        return (n(B, S, nh, hd), dt, -dt, n(B, S, ds), n(B, S, ds))
    return (n(B, S, nh, hd, scale=0.5), n(B, S, nh, hd, scale=0.5),
            n(B, S, nh, hd, scale=0.5), -torch.exp(n(B, S, nh, hd,
                                                     scale=1.5) - 2.0),
            n(nh, hd, scale=0.3))


def _chunked(name, *a):
    return mamba2.ssd_chunked(*a, chunk=32) if name == "ssd" \
        else rwkv6.wkv_chunked(*a)


def _oracle(name, *a):
    return (ops.ssd_scan if name == "ssd" else ops.rwkv6_scan)(
        *a, force_ref=True)


@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("name", ["ssd", "wkv"])
def test_chunked_scans_match_oracles_in_f64(name, S):
    """Values (y and the final state) and the gradients of every input
    of a random projection of both, against the sequential oracle."""
    results = []
    for fn in (_chunked, _oracle):
        args = [t.clone().requires_grad_() for t in _scan_inputs(
            name, S, np.random.default_rng(S))]
        y, s = fn(name, *args)
        assert y.dtype == s.dtype == torch.float64
        loss = (y * torch.from_numpy(np.random.default_rng(1).standard_normal(
            y.shape))).sum() + (s * torch.from_numpy(
                np.random.default_rng(2).standard_normal(s.shape))).sum()
        grads = torch.autograd.grad(loss, args)
        results.append((y.detach(), s.detach()) + grads)
    for got, want in zip(*results):
        _close(got, want.numpy(), **F64_TOL)


def _with_chunk(cfg, chunk: int):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                            chunk=chunk))


def _count(layer, x, grad: bool) -> float:
    def step(x):
        if not grad:
            with torch.no_grad():
                return layer(x)
        y = layer(x)
        y.sum().backward()
        return y.detach()
    return analysis.count_step(step, (x,))["cost"]["flops"]


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_scan_layer_counts_as_the_oracle(arch, grad, monkeypatch):
    """A scan layer's FLOPs on ``force_ref`` (the chunked math), forward
    alone or forward and backward with the parameters needing gradients,
    at two chunk lengths (several chunks and one), equal its count with
    the sequential oracle in place of the chunked scan."""
    _, cfg, _, p = _layer(arch)
    p = {k: v.detach().clone().requires_grad_(v.is_floating_point())
         for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32))
    if arch == "zamba2-7b":
        def layer(chunk):
            c = _with_chunk(cfg, chunk)
            return lambda x: mamba2.mamba2_forward(c, p, x,
                                                   force_ref=True)[0]
        counts = [_count(layer(chunk), x, grad) for chunk in (16, 64)]
        monkeypatch.setattr(mamba2, "ssd_chunked", lambda *a: _oracle(
            "ssd", *a[:5]))
        counts.append(_count(layer(16), x, grad))
    else:
        def layer(x):
            return rwkv6.rwkv6_time_mix(cfg, p, x, x[:, 0],
                                        force_ref=True)[0]
        chunked = rwkv6.wkv_chunked
        counts = []
        for chunk in (16, 128):
            monkeypatch.setattr(rwkv6, "wkv_chunked",
                                functools.partial(chunked, chunk=chunk))
            counts.append(_count(layer, x, grad))
        monkeypatch.setattr(rwkv6, "wkv_chunked", lambda *a: _oracle(
            "wkv", *a))
        counts.append(_count(layer, x, grad))
    assert counts[0] == counts[1] == counts[2] > 0, counts


def _reduced_for_the_pod(arch: str):
    """Reduced configs whose heads divide the production mesh's 16-wide
    model axis: zamba2 at 3 layers with the shared block every 2 (16 SSD
    heads), rwkv6 at d_model 512 (16 wkv heads)."""
    if arch == "zamba2-7b":
        return dataclasses.replace(reduced(get_config(arch), n_layers=3),
                                   attn_every=2)
    return reduced(get_config(arch), d_model=512)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_scan_dryrun_completes_and_extrapolates(arch, shape, monkeypatch):
    """A reduced scan model's dry-run on the production mesh at the full
    shape (S 4,096 with its backward, S 32,768) completes on the chunked
    math, and the depth points' affine extrapolation equals the direct
    full-depth count."""
    import torch.distributed as dist
    monkeypatch.setattr(dryrun, "get_config", _reduced_for_the_pod)
    try:
        res = dryrun.roofline_combo(arch, shape)
        direct = dryrun.lower_combo(arch, shape, False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert res["ok"] and direct["ok"]
    roof = res["roofline"]
    assert roof["flops_per_device"] == direct["cost_analysis"]["flops"] > 0
    assert roof["bytes_per_device"] == \
        direct["cost_analysis"]["bytes accessed"]
    assert roof["collective_bytes_per_device"] == \
        direct["collectives"]["total"]


def test_chunked_counts_like_the_oracle_at_a_meta_shape():
    """On meta tensors (the dry-run's stand-ins) the chunked scans count
    the oracle's 2 hd ds (SSD) and 2 hd^2 (wkv) FLOPs a token and head,
    whatever the chunk length, without walking S."""
    B, S, nh, hd, ds = 2, 32768, 4, 64, 64
    x = torch.empty(B, S, nh, hd, device="meta")
    dt = torch.empty(B, S, nh, device="meta")
    bc = torch.empty(B, S, ds, device="meta")
    for chunk in (64, 256):
        res = analysis.count_step(
            lambda *a: mamba2.ssd_chunked(*a, chunk=chunk),
            (x, dt, dt, bc, bc))
        assert res["cost"]["flops"] == 2 * B * nh * S * hd * ds
    u = torch.empty(nh, hd, device="meta")
    for chunk in (64, 128):
        res = analysis.count_step(
            lambda *a: rwkv6.wkv_chunked(*a, chunk=chunk), (x, x, x, x, u))
        assert res["cost"]["flops"] == 2 * B * nh * S * hd * hd


def test_reference_path_runs_the_chunked_scans(monkeypatch):
    """``force_ref`` on a whole scan model reaches the chunked math and
    never the sequential oracles (the trainer's and the dry-run's path)."""
    from repro_torch.kernels import ref
    from repro_torch.models import forward

    def refuse(*a, **k):
        raise AssertionError("the sequential oracle ran")
    monkeypatch.setattr(ref, "ssd_scan_ref", refuse)
    monkeypatch.setattr(ref, "rwkv_scan_ref", refuse)
    for arch in ("zamba2-7b", "rwkv6-1.6b"):
        cfg = _configs(arch)[1]
        params = init_params(cfg, seed=0, device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 40)))
        logits = forward(cfg, params, tokens, force_ref=True).logits
        assert torch.isfinite(logits).all()
