"""Zamba2 as published (``zamba2-7b-instruct``, the port's own id) on the
CPU at a tiny published-form size, and its kernels on the card.

The tiny form (``portbench/test_portbench_zamba2.py``'s): d 64, 8 Mamba2
layers, shared blocks before layers 1, 3, 4 and 6 (two blocks in turn),
4 heads of 32 over the 128-wide [h, x0], 8 SSD heads of 16 in 2 groups,
adapters of rank 8, f32, weights drawn from a seed by
``portbench.weights`` in the benchmark's layout. Against the benchmark's
plain reference (``portbench/reference/zamba2.py``): the port's plain
versions' forward (logits at 1e-4: f32 throughout, the two sides sum the
chunked SSD, the attention and the norms in other orders over eight
layers, about 2e-5 apart), prefill then decode through the paged engine
at every served position (the same 1e-4), the paged engine against the
slot engine token for token, a refilled slot against the request served
alone, the pool's invariants after retirements, the engine's spans and
counters; and the reference against ``transformers``'
``Zamba2ForCausalLM`` (eager attention, its plain Mamba2 path, which
floors the step size at ``time_step_min`` as the reference does) on the
same weights, at 1e-4 for the same reason. On the card (``-m cuda``):
flash at 32 heads x 224 with scale 112^-0.5, paged decode at 224 (G 1)
with that scale, the SSD scan with 2 groups over 112 heads of 64, each
against its plain version at the repo's kernel tolerances, and the
published hybrid's replayed chunk against the same step run eagerly,
with its phase events read.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.compat import cap_xdist_threads
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, forward, init_params,
                                reduced)
from repro_torch.models.config import Zamba2Config
from repro_torch.obs.trace import Tracer
from repro_torch.serving import ContinuousBatchingEngine

from portbench import weights
from portbench.families import zamba2 as fam
from portbench.reference import zamba2 as ref
from portbench.test_portbench_zamba2 import tiny_spec

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

SEED = 2**32 + 5
#: f32 logits of two plain f32 computations over 8 layers (see above)
TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE = dict(max_slots=3, capacity=48, chunk=4, block_size=8)
#: (prompt length, budget): two groups of equal length, a long prompt
#: that waits for a row, and a one-token answer
SHAPES = [(9, 5), (9, 3), (14, 7), (5, 1), (9, 4), (30, 6)]


@pytest.fixture(scope="module")
def model():
    spec = tiny_spec()
    leaves = fam.leaves(spec)
    cfg = fam.port_config(spec)
    params = weights.build(leaves, spec["num_hidden_layers"], SEED,
                           torch.float32, "cpu")
    return spec, leaves, cfg, params


def _requests(vocab):
    rng = np.random.default_rng(3)
    return [(i, rng.integers(0, vocab, n), b, 1)
            for i, (n, b) in enumerate(SHAPES)]


def _drain(eng, reqs):
    pending, done = list(reqs), {}
    while pending or eng.n_active:
        if pending:
            flags = eng.admit_many(pending)
            pending = [r for r, ok in zip(pending, flags) if not ok]
        for s in eng.step_chunk():
            done[s.rid] = s.tokens
        assert eng.check_block_invariants()
    return done


# ------------------------------------------------------------ the config
def test_config_is_the_published_model():
    cfg = get_config("zamba2-7b-instruct")
    assert isinstance(cfg, Zamba2Config) and cfg.published_hybrid
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff,
            cfg.vocab_size) == (81, 3584, 32, 224, 14336, 32000)
    assert cfg.hybrid_layer_ids == (6, 11, 17, 23, 29, 35, 41, 47, 53, 59,
                                    65, 71, 77)
    assert (cfg.num_mem_blocks, cfg.adapter_rank, cfg.norm_eps) == (
        2, 128, 1e-5)
    assert cfg.attn_scale == pytest.approx(112 ** -0.5)
    assert (cfg.ssm.n_groups, cfg.ssm.dt_min, cfg.ssm.chunk) == (2, 1e-3,
                                                                 256)
    assert cfg.tie_embeddings
    assert cfg.param_count() == 7_355_225_088      # 7.36 B, 14.7 GB bf16
    cfg.validate(paged=True)
    # the JAX package's id keeps its own layout and fields
    old = get_config("zamba2-7b")
    assert not old.published_hybrid and old.ssm.n_groups == 1
    assert "hybrid_layer_ids" not in {f.name for f in
                                      dataclasses.fields(old)}
    small = reduced(cfg)
    small.validate(paged=True)
    assert small.hybrid_layer_ids == (0, 1) and small.hd == 128


@pytest.mark.parametrize("bad", [dict(hybrid_layer_ids=(3, 3)),
                                 dict(hybrid_layer_ids=(9,)),
                                 dict(num_mem_blocks=0)])
def test_config_refuses(bad):
    cfg = reduced(get_config("zamba2-7b-instruct"), n_layers=4)
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, **bad).validate()


# ------------------------------------------------------- the reference
def test_forward_matches_reference(model):
    spec, leaves, cfg, params = model
    rng = np.random.default_rng(0)
    seqs = [(rng.integers(0, 256, 21), 7), (rng.integers(0, 256, 13), 13),
            (rng.integers(0, 256, 40), 1)]
    want = ref.logits(spec, leaves, SEED, seqs, "cpu")
    for (toks, P), w in zip(seqs, want):
        got = forward(cfg, params, torch.as_tensor(toks)[None]).logits[0]
        torch.testing.assert_close(got[P - 1:], w, **TOL)
        ref_path = forward(cfg, params, torch.as_tensor(toks)[None],
                           force_ref=True).logits[0]
        torch.testing.assert_close(ref_path[P - 1:], w, **TOL)


def test_prefill_then_decode_matches_reference(model):
    spec, leaves, cfg, params = model
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, 24)
    P = 10
    for paged in (False, True):
        out = forward(cfg, params, torch.as_tensor(toks[None, :P]),
                      return_cache=True, cache_capacity=32)
        cache = out.cache
        if paged:
            from repro_torch.models import init_paged_decode_cache
            pc = init_paged_decode_cache(cfg, 1, 6, 8, 4, "cpu")
            pc["shared"].block_tables[0] = torch.tensor(
                [4, 1, 5, 0], dtype=torch.int32)
            k, v = out.cache["shared"].k, out.cache["shared"].v
            for pos in range(P):
                blk = pc["shared"].block_tables[0, pos // 8]
                pc["shared"].k[:, blk, pos % 8] = k[:, 0, pos]
                pc["shared"].v[:, blk, pos % 8] = v[:, 0, pos]
            pc["shared"].length[0] = P
            for dst, src in zip(pc["mamba"], out.cache["mamba"]):
                if isinstance(dst, torch.Tensor):
                    dst.copy_(src)
            cache = pc
        logits = [out.logits[0, -1]]
        for t in range(P, len(toks) - 1):
            o = decode_step(cfg, params, torch.as_tensor(toks[None, t:t + 1]),
                            cache)
            cache = o.cache
            logits.append(o.logits[0, 0])
        want, = ref.logits(spec, leaves, SEED, [(toks[:-1], P)], "cpu")
        torch.testing.assert_close(torch.stack(logits), want, **TOL)


def test_reference_matches_transformers(model):
    """The reference against ``transformers``' own Zamba2 on the same
    weights: its plain paths (no mamba_ssm here), the step size floored
    at ``time_step_min`` as the reference names. Its plain SSD is right
    within a chunk and carries the state between chunks wrongly (4.57:
    off by 0.1-0.7 from a sequential recurrence past the first chunk,
    which the port and the reference match to 1e-6), so it takes the
    19 tokens as one chunk, while the reference carries 3 chunks of 8."""
    tf = pytest.importorskip("transformers")
    spec, leaves, _, params = model
    conf = tf.Zamba2Config(
        vocab_size=spec["vocab_size"], hidden_size=spec["hidden_size"],
        num_hidden_layers=spec["num_hidden_layers"],
        layers_block_type=spec["layers_block_type"],
        num_attention_heads=spec["num_attention_heads"],
        num_key_value_heads=spec["num_key_value_heads"],
        intermediate_size=spec["intermediate_size"],
        hidden_act=spec["hidden_act"], mamba_d_state=spec["mamba_d_state"],
        mamba_d_conv=spec["mamba_d_conv"], mamba_expand=spec["mamba_expand"],
        mamba_ngroups=spec["mamba_ngroups"],
        n_mamba_heads=spec["n_mamba_heads"],
        chunk_size=32, num_mem_blocks=spec["num_mem_blocks"],
        adapter_rank=spec["adapter_rank"], use_mem_rope=True,
        use_shared_attention_adapter=False, rope_theta=spec["rope_theta"],
        rms_norm_eps=spec["rms_norm_eps"],
        time_step_min=spec["time_step_min"],
        time_step_max=spec["time_step_max"],
        time_step_floor=spec["time_step_floor"], tie_word_embeddings=True,
        attn_implementation="eager")
    hf = tf.Zamba2ForCausalLM(conf).eval()
    _load_transformers(hf, spec, params)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, spec["vocab_size"], 19)
    with torch.no_grad():
        got = hf(torch.as_tensor(toks)[None], use_cache=False).logits[0]
    want, = ref.logits(spec, leaves, SEED, [(toks, 1)], "cpu")
    torch.testing.assert_close(got, want, **TOL)


def _load_transformers(hf, spec, params):
    """Copy the benchmark's tree into ``Zamba2ForCausalLM``: the four
    input projections of a Mamba2 layer as ``in_proj`` [z, x, B/C, dt],
    its two convs as ``conv1d``, application j's block ``j % M``, its
    adapter ``j`` and its linear."""
    m, blocks = hf.model, params["blocks"]
    M = spec["num_mem_blocks"]

    def put(mod, t):
        with torch.no_grad():
            mod.copy_(t)
    put(m.embed_tokens.weight, params["embed"]["tok"])
    put(m.final_layernorm.weight, params["final_norm"]["scale"])
    j = 0
    for i, layer in enumerate(m.layers):
        mb = layer.mamba_decoder if hasattr(layer, "mamba_decoder") \
            else layer
        mx, w = mb.mamba, {k: v[i] for k, v in blocks["mamba"].items()}
        put(mb.input_layernorm.weight, blocks["ln1"]["scale"][i])
        put(mx.in_proj.weight, torch.cat([w["z_proj"], w["x_proj"],
                                          w["bc_proj"], w["dt_proj"]], 1).T)
        put(mx.conv1d.weight, torch.cat([w["conv_x"], w["conv_bc"]],
                                        1).T[:, None, :])
        put(mx.conv1d.bias, torch.cat([w["conv_b_x"], w["conv_b_bc"]]))
        for name in ("A_log", "D", "dt_bias"):
            put(getattr(mx, name), w[name])
        put(mx.norm.weight, w["norm"])
        put(mx.out_proj.weight, w["out_proj"].T)
        if hasattr(layer, "shared_transformer"):
            st, s, b = layer.shared_transformer, params["shared"], j % M
            assert st.block_id == b
            put(st.input_layernorm.weight, s["ln1"]["scale"][b])
            put(st.pre_ff_layernorm.weight, s["ln2"]["scale"][b])
            for name, proj in (("wq", "q_proj"), ("wk", "k_proj"),
                               ("wv", "v_proj"), ("wo", "o_proj")):
                put(getattr(st.self_attn, proj).weight, s["attn"][name][b].T)
            ff = st.feed_forward
            put(ff.gate_up_proj.weight, s["mlp"]["gate_up"][b].T)
            put(ff.down_proj.weight, s["mlp"]["down"][b].T)
            ad = ff.gate_up_proj_adapter_list[j]
            put(ad[0].weight, params["apps"]["lora_a"][j].T)
            put(ad[1].weight, params["apps"]["lora_b"][j].T)
            put(layer.linear.weight, params["apps"]["linear"][j].T)
            j += 1
    assert j == len(spec["hybrid_layer_ids"])


# ---------------------------------------------------------- the engine
def test_paged_engine_matches_reference_at_every_served_position(
        model, monkeypatch):
    """Prefill then decode through the paged engine: the logits it
    chooses each token from equal the reference's full forward over the
    prompt and the tokens served before."""
    spec, leaves, cfg, params = model
    seen = {}
    orig = ContinuousBatchingEngine._next_tokens

    def record(self, logits, rids, gidx):
        for r, g, row in zip(rids.tolist(), gidx.tolist(), logits):
            seen.setdefault((r, g), row.clone())
        return orig(self, logits, rids, gidx)
    monkeypatch.setattr(ContinuousBatchingEngine, "_next_tokens", record)
    reqs = _requests(spec["vocab_size"])
    eng = ContinuousBatchingEngine(cfg, params, paged=True, n_blocks=14,
                                   **ENGINE)
    done = _drain(eng, reqs)
    for rid, prompt, budget, extra in reqs:
        toks = done[rid]
        assert len(toks) == budget + extra
        want, = ref.logits(spec, leaves, SEED, [(np.concatenate(
            [prompt, np.asarray(toks[:-1])]), len(prompt))], "cpu")
        got = torch.stack([seen[(rid, g)] for g in range(len(toks))])
        torch.testing.assert_close(got, want, **TOL)


def test_paged_matches_slot_and_alone(model):
    """Token for token: the paged engine (back-pressured by a 14-block
    pool) and the slot engine; every request as served alone, so a
    refilled slot keeps nothing of the request it held."""
    spec, _, cfg, params = model
    reqs = _requests(spec["vocab_size"])
    paged = ContinuousBatchingEngine(cfg, params, paged=True, n_blocks=14,
                                     **ENGINE)
    got = _drain(paged, reqs)
    assert paged.allocator.n_allocated == 0
    assert paged.allocator.reserved == 0
    assert got == _drain(ContinuousBatchingEngine(cfg, params, **ENGINE),
                         reqs)
    for r in reqs:
        alone = ContinuousBatchingEngine(cfg, params, paged=True,
                                         n_blocks=14, **ENGINE)
        assert _drain(alone, [r]) == {r[0]: got[r[0]]}


def test_paged_pool_layout(model):
    _, _, cfg, params = model
    eng = ContinuousBatchingEngine(cfg, params, paged=True, n_blocks=14,
                                   **ENGINE)
    pc = eng.cache["shared"]
    assert tuple(pc.k.shape) == (4, 15, 8, cfg.n_kv_heads, cfg.hd)
    assert eng.cache["mamba"].ssd.shape[:2] == (cfg.n_layers, 3)
    assert eng.cache["mamba"].ssd.dtype == torch.float32


@pytest.mark.parametrize("paged", [True, False])
def test_admission_rows_capped_by_state_bytes(model, paged):
    """Three equal-length prompts against a cap of two rows' recurrent
    state: the admission prefills two rows, then one, and every request
    gets the tokens of the uncapped engine, which prefills all three at
    once."""
    spec, _, cfg, params = model
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(0, spec["vocab_size"], 9), 3, 1)
            for i in range(3)]
    kw = dict(paged=paged, n_blocks=14 if paged else None, **ENGINE)

    def groups(eng):
        sizes, admit = [], eng._admit_group
        eng._admit_group = lambda g: (sizes.append(len(g)), admit(g))[1]
        return sizes, _drain(eng, reqs)

    full = ContinuousBatchingEngine(cfg, params, **kw)
    assert full._batch_rows() == 3
    full_sizes, want = groups(full)
    capped = ContinuousBatchingEngine(cfg, params, **kw)
    row = sum(t.numel() * t.element_size() for t in capped.cache["mamba"]
              if isinstance(t, torch.Tensor)) // 3
    capped.ADMIT_STATE_BYTES = 2 * row + row // 2
    assert capped._batch_rows() == 2
    sizes, got = groups(capped)
    assert (full_sizes, sizes) == ([3], [2, 1])
    assert got == want


def test_traced_engine_spans_and_counters(model, monkeypatch):
    """Traced: ``continuous.admit.insert`` inside each admission, and
    ``kv_blocks`` / ``state_rows`` on each chunk's stats; on the CPU no
    CUDA event and no phase times."""
    spec, _, cfg, params = model

    def refuse(*a, **k):
        raise AssertionError("a CUDA event on the CPU")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    tr = Tracer()
    eng = ContinuousBatchingEngine(cfg, params, paged=True, n_blocks=14,
                                   tracer=tr, **ENGINE)
    _drain(eng, _requests(spec["vocab_size"]))
    evs = [e for e in tr.to_chrome()["traceEvents"] if e.get("ph") == "X"]
    admits = [e for e in evs if e["name"] == "continuous.admit"]
    inserts = [e for e in evs if e["name"] == "continuous.admit.insert"]
    assert len(inserts) == len(admits) > 0
    for a, i in zip(admits, inserts):
        assert a["ts"] <= i["ts"] and i["ts"] + i["dur"] <= a["ts"] + a["dur"]
    stats = [e["args"] for e in evs if e["name"] == "continuous.chunk.stats"]
    assert stats and all(set(a) == {"kv_blocks", "state_rows"}
                         for a in stats)
    assert all(a["state_rows"] == 3 and 0 < a["kv_blocks"] <= 14
               for a in stats)


def test_launcher_serves_the_published_id():
    from repro_torch.launch import serve
    rep = serve.main(["--arch", "zamba2-7b-instruct", "--reduced",
                      "--device", "cpu", "--real-engine", "--queries", "2"])
    assert rep["n"] == 2 and rep["tokens_generated"] > 0


def _grouped_case(dev, dtype, B, S, nh, hd, ds, seed):
    """x [B, S, nh, hd]; dt, la [B, S, nh]; B/C rows [B, S, 2 ds] of 2
    groups, as the model's projections lay them out."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, S, nh, hd, generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, nh, generator=g, device=dev) - 2.0)
    la = -dt * torch.arange(1, nh + 1, device=dev) / 16
    bm, cm = (torch.randn(B, S, 2 * ds, generator=g, device=dev).to(dtype)
              for _ in range(2))
    return x, dt, la, bm, cm


def _oracle(x, dt, la, bm, cm):
    """The sequential oracle on B/C repeated per head: head k reads group
    k // (nh / 2)."""
    from repro_torch.kernels import ops
    B, S, nh, hd = x.shape
    ys, ss = [], []
    for h in range(nh):
        j = h // (nh // 2)
        ds = bm.shape[-1] // 2
        y, s = ops.ssd_scan(x[:, :, h:h + 1].float(), dt[..., h:h + 1],
                            la[..., h:h + 1],
                            bm[..., j * ds:(j + 1) * ds].float(),
                            cm[..., j * ds:(j + 1) * ds].float(),
                            force_ref=True)
        ys.append(y)
        ss.append(s)
    return torch.cat(ys, dim=2), torch.cat(ss, dim=1)


def test_grouped_scan_reads_each_heads_group():
    """The model's per-group scan (one call a group over its heads'
    slice) on the plain version and on the reference math, against the
    sequential oracle head by head (f32: 1e-5)."""
    from repro_torch.kernels import ops
    from repro_torch.models import mamba2
    args = _grouped_case("cpu", torch.float32, 2, 13, 6, 8, 4, 9)
    wy, ws = _oracle(*args)
    for fn in (ops.ssd_scan, lambda *a: mamba2.ssd_chunked(*a, 4)):
        y, s = mamba2._per_group(fn, 2, *args)
        torch.testing.assert_close(y, wy, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(s, ws, rtol=1e-5, atol=1e-5)


def test_scale_reaches_the_plain_attention():
    """The softmax scale: every plain version and oracle takes it, and
    None is ``hd ** -0.5`` exactly as before."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref as kref
    g = torch.Generator().manual_seed(10)
    q = torch.randn(1, 2, 1, 7, 32, generator=g)
    k, v = (torch.randn(1, 2, 7, 32, generator=g) for _ in range(2))
    base = fa.flash_attention_plain(q, k, v)
    assert torch.equal(base, fa.flash_attention_plain(q, k, v,
                                                      scale=32 ** -0.5))
    scaled = fa.flash_attention_plain(q, k, v, scale=16 ** -0.5)
    want = kref.flash_attention_ref(q[0, :, 0], k[0], v[0],
                                    scale=16 ** -0.5)
    torch.testing.assert_close(scaled[0, :, 0], want, rtol=1e-5, atol=1e-5)
    assert not torch.allclose(scaled, base)
    qd = torch.randn(1, 2, 1, 32, generator=g)
    valid = torch.ones(1, 7, dtype=torch.bool)
    got = da.decode_attention_plain(qd, k, v, valid, 16 ** -0.5)
    want = kref.decode_attention_ref(qd[0], k[0], v[0],
                                     valid.expand(2, 7), scale=16 ** -0.5)
    torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _tol(dtype):
    return 2e-5 if dtype == torch.float32 else 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [37, 128])
def test_flash_hd224_scaled_matches_plain(cuda_device, dtype, S):
    """The shared block's prefill: 32 heads of 224 (G 1), scale
    112^-0.5; bf16 on the tensor-core route at HDP 256."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain, flash_plan)
    g = torch.Generator(device=cuda_device).manual_seed(21)
    H, hd, scale = 32, 224, 112 ** -0.5
    q = torch.randn(1, S, H, 1, hd, generator=g, device=cuda_device) \
        .to(dtype).permute(0, 2, 3, 1, 4)
    kv = torch.randn(2, 1, S, H, hd, generator=g, device=cuda_device) \
        .to(dtype)
    k, v = kv[0].permute(0, 2, 1, 3), kv[1].permute(0, 2, 1, 3)
    if dtype == torch.bfloat16:
        assert flash_plan(1, H, 1, S, hd, dtype, 132).hd_pad == 256
    reset_launches()
    got = flash_attention(q, k, v, scale=scale)
    assert LAUNCHES["flash_attention"] == 1
    want = flash_attention_plain(q, k, v, scale=scale)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_hd224_scaled_matches_plain(cuda_device, dtype):
    """One application's layer of the pool: 32 kv heads of 224, G 1,
    blocks of 16, slots at 17, 700 and 2047 positions, scale 112^-0.5."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention, paged_decode_attention_plain)
    g = torch.Generator(device=cuda_device).manual_seed(22)
    H, hd, bs, n_bt = 32, 224, 16, 128
    P = 3 * n_bt
    pos_list = [17, 700, 2047]
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(2))
    tables = torch.full((3, n_bt), P, dtype=torch.int32)
    used = 0
    for b, p in enumerate(pos_list):
        n = p // bs + 1
        tables[b, :n] = perm[used:used + n]
        used += n
    tables = tables.to(cuda_device)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=cuda_device)
    q = torch.randn(3, H, 1, hd, generator=g, device=cuda_device).to(dtype)
    pool = torch.randn(2, 2, P + 1, bs, H, hd, generator=g,
                       device=cuda_device).to(dtype)
    kp, vp = pool[0, 1, :P], pool[1, 1, :P]
    reset_launches()
    got = paged_decode_attention(q, kp, vp, tables, pos, scale=112 ** -0.5)
    assert LAUNCHES["paged_decode_attention"] == 1
    want = paged_decode_attention_plain(q, kp, vp, tables, pos,
                                        112 ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [18, 128])
def test_ssd_scan_two_groups_matches_plain(cuda_device, dtype, S):
    """The published Mamba2's prefill: 112 heads of 64, state 64, B/C in
    2 groups (heads 0-55 read group 0's), one launch a group over its
    heads' slice, against the plain version on B/C repeated per head
    (tests/test_kernels.py's scan tolerances)."""
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    from repro_torch.models import mamba2
    H = 112
    x, dt, la, bm, cm = _grouped_case(cuda_device, dtype, 2, S, H, 64, 64,
                                      23)
    reset_launches()
    y, sf = mamba2._per_group(ops.ssd_scan, 2, x, dt, la, bm, cm)
    assert LAUNCHES["ssd_scan"] == 2
    per_head = [t.unflatten(-1, (2, -1)).repeat_interleave(H // 2, dim=2)
                .permute(0, 2, 1, 3) for t in (bm, cm)]
    wy, wsf = ssd_scan_plain(x.permute(0, 2, 1, 3), dt.permute(0, 2, 1),
                             la.permute(0, 2, 1), *per_head)
    scale = float(wy.float().abs().max())
    tol = (dict(rtol=1e-3, atol=2e-5 * scale) if dtype == torch.float32
           else dict(rtol=5e-2, atol=5e-2 * scale))
    torch.testing.assert_close(y.float(), wy.permute(0, 2, 1, 3).float(),
                               **tol)
    torch.testing.assert_close(sf, wsf, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_published_hybrid_graph_equals_eager_and_times_phases(cuda_device):
    """Reduced zamba2-7b-instruct in bf16 on the paged engine: the
    replayed chunk's tokens equal the same step run eagerly, and a
    traced engine's replayed chunks give ``mamba_ms`` and ``shared_ms``
    (external events inside the captured step), each below ``step_ms``
    summed with the other."""
    from repro_torch.obs import graph_hooks
    cfg = dataclasses.replace(reduced(get_config("zamba2-7b-instruct"),
                                      n_layers=4), dtype="bfloat16")
    params = init_params(cfg, 0, cuda_device)
    reqs = _requests(cfg.vocab_size)
    runs = []
    for eager in (False, True):
        tr = Tracer()
        eng = ContinuousBatchingEngine(cfg, params, paged=True, n_blocks=14,
                                       tracer=tr, **ENGINE)
        if eager:
            eng._graphs = graph_hooks.GraphCache("eager", "cpu")
        runs.append(_drain(eng, reqs))
        if not eager:
            stats = [e["args"] for e in tr.to_chrome()["traceEvents"]
                     if e.get("name") == "continuous.chunk.stats"
                     and "mamba_ms" in e.get("args", {})]
            assert stats
            for a in stats:
                assert a["mamba_ms"] > 0 and a["shared_ms"] > 0
                assert a["mamba_ms"] + a["shared_ms"] <= 1.5 * a["step_ms"]
    assert runs[0] == runs[1]
