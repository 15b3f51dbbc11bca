"""The continuous engine's phase spans and the MoE's routing counts
(``serving/continuous.py``, ``obs/trace.py``, ``models/moe.py``), and the
benchmark's readers of them (``portbench/metrics``).

A traced engine (reduced ``deepseek-moe-16b`` at capacity factor 1.25,
where a prefill drops pairs, and reduced ``qwen3-0.6b``, f32, on the
CPU) ends each ``continuous.admit`` with ``continuous.admit.read`` and
follows it with ``continuous.admit.stats``, and records each chunk as
``continuous.chunk.prepare``, ``continuous.decode_chunk``,
``continuous.chunk.stats`` and ``continuous.chunk.retire``, back to back;
the two spans the JAX engine records keep their names and args (held
against it in ``tests/test_torch_hooks.py``). The routing counts are held to a NumPy
count of the experts ``moe._route`` chose on the same inputs. An
untraced engine installs no hook, makes no count buffer and no CUDA
event, and serves the same tokens. The readers are run on a hand-made
run context and held to numbers reckoned here. On a card (``-m cuda``)
the device's step times are held against the chunk's wall span, and
nothing between the prefill's enqueueing and the first tokens' read
waits for the stream.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.profile import Slice
from repro_torch.compat import cap_xdist_threads
from repro_torch.configs import get_config
from repro_torch.models import init_params, moe, reduced
from repro_torch.obs import graph_hooks
from repro_torch.obs.trace import WALL_PID, NullTracer, Tracer
from repro_torch.serving import ContinuousBatchingEngine

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

ENGINE = dict(max_slots=3, capacity=64, chunk=4, paged=True, block_size=8)
# (prompt length, budget): a 40-token prompt drops pairs at factor 1.25,
# a one-token prompt is dispatched dropless, and the fourth request waits
# for a free row
SHAPES = [(40, 5), (9, 3), (17, 6), (1, 2)]
# the host's time between a span's edge and its child's: a few Python
# statements
TILE_TOL_S = 1e-3
PHASES = ("continuous.admit.read", "continuous.admit.stats",
          "continuous.chunk.prepare", "continuous.chunk.stats",
          "continuous.chunk.retire")
#: the engine's spans of one chunk, in order
CHUNK = ("continuous.chunk.prepare", "continuous.decode_chunk",
         "continuous.chunk.stats", "continuous.chunk.retire")


def _config(arch):
    cfg = reduced(get_config(arch))
    if cfg.moe is not None and cfg.moe.n_experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.25))
    return cfg


@pytest.fixture(scope="module", params=["deepseek-moe-16b", "qwen3-0.6b"])
def model(request):
    cfg = _config(request.param)
    return cfg, init_params(cfg, 0, "cpu")


@pytest.fixture(scope="module")
def moe_model():
    cfg = _config("deepseek-moe-16b")
    return cfg, init_params(cfg, 0, "cpu")


@pytest.fixture(autouse=True)
def _clean_counters():
    graph_hooks.reset()
    yield
    graph_hooks.reset()


def _requests(vocab):
    rng = np.random.default_rng(7)
    return [(i, rng.integers(1, vocab, n), b, 1)
            for i, (n, b) in enumerate(SHAPES)]


def drain(eng, reqs, chunk=None):
    """Admit-all / step loop; the tokens per request and the occupancy
    before each chunk."""
    pending, done, occupancy = list(reqs), {}, []
    while pending or eng.n_active:
        if pending:
            flags = eng.admit_many(pending)
            pending = [r for r, ok in zip(pending, flags) if not ok]
        occupancy.append(eng.n_active)
        for s in eng.step_chunk(chunk):
            done[s.rid] = s.tokens
    return done, occupancy


def wall(tracer):
    """The wall spans as (name, start, end, args), in order of start."""
    evs = [e for e in tracer.to_chrome()["traceEvents"]
           if e["ph"] == "X" and e["pid"] == WALL_PID]
    out = [(e["name"], e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
            e.get("args") or {}) for e in evs]
    return sorted(out, key=lambda s: s[1])


def named(spans, name):
    return [s for s in spans if s[0] == name]


def inside(spans, name, parent):
    return [s for s in named(spans, name)
            if parent[1] <= s[1] and s[2] <= parent[2]]


@pytest.fixture(scope="module")
def traced(model):
    cfg, params = model
    tr = Tracer()
    eng = ContinuousBatchingEngine(cfg, params, tracer=tr, **ENGINE)
    done, occupancy = drain(eng, _requests(cfg.vocab_size))
    return cfg, eng, tr, done, occupancy


# ------------------------------------------------------------ the spans
def test_admission_ends_with_its_read(traced):
    """Each ``continuous.admit`` holds one ``continuous.admit.read``, which
    ends it (up to the host's few statements), and the next engine span
    is its ``continuous.admit.stats``."""
    _, _, tr, _, _ = traced
    spans = wall(tr)
    admits = named(spans, "continuous.admit")
    assert admits
    for p in admits:
        (r,) = inside(spans, "continuous.admit.read", p)
        assert p[1] < r[1] and p[2] - r[2] <= TILE_TOL_S
        nxt = [s for s in spans if s[1] >= p[2]][0]
        assert nxt[0] == "continuous.admit.stats"
        assert nxt[1] - p[2] <= TILE_TOL_S
    assert len(named(spans, "continuous.admit.stats")) == len(admits)
    for kid in PHASES:      # every phase is recorded
        assert named(spans, kid), kid


def test_prepare_chunk_stats_retire_in_order(traced):
    """Each chunk is ``continuous.chunk.prepare``,
    ``continuous.decode_chunk``, ``continuous.chunk.stats`` and
    ``continuous.chunk.retire`` back to back, and no other engine span
    falls between them."""
    _, _, tr, _, occupancy = traced
    spans = [s for s in wall(tr) if s[0] in CHUNK + ("continuous.admit",)]
    chunks = named(spans, "continuous.decode_chunk")
    assert len(chunks) == len(occupancy)
    assert all(len(named(spans, n)) == len(chunks) for n in CHUNK)
    for i, s in enumerate(spans):
        if s[0] != "continuous.decode_chunk":
            continue
        run = spans[i - 1:i + 3]
        assert tuple(x[0] for x in run) == CHUNK
        for x, y in zip(run, run[1:]):
            assert x[2] <= y[1] and y[1] - x[2] <= TILE_TOL_S


def test_existing_spans_keep_their_args(traced):
    """``continuous.admit`` (rows, S) and ``continuous.decode_chunk``
    (chunk, occupancy, tokens_in_use) as before; the phases carry args
    only where the module's docstring says (no device times on the
    CPU)."""
    cfg, eng, tr, _, occupancy = traced
    spans = wall(tr)
    is_moe = cfg.backbone_kind == "moe"
    admits = [a for _, _, _, a in named(spans, "continuous.admit")]
    if is_moe:      # capacity dispatch: one request a prefill
        assert admits == [{"rows": 1, "S": n} for n, _ in SHAPES]
    else:
        assert all(set(a) == {"rows", "S"} for a in admits)
        assert sum(a["rows"] for a in admits) == len(SHAPES)
    chunks = [a for _, _, _, a in named(spans, "continuous.decode_chunk")]
    assert [a["occupancy"] for a in chunks] == occupancy
    assert all(set(a) == {"chunk", "occupancy", "tokens_in_use"}
               and a["chunk"] == eng.chunk for a in chunks)
    for name, moe_args in (("continuous.admit.stats",
                            {"pairs", "kept", "experts_hit"}),
                           ("continuous.chunk.stats",
                            {"pairs", "experts_hit"})):
        for _, _, _, a in named(spans, name):
            assert set(a) == (moe_args if is_moe else set()), name
    for name in ("continuous.admit.read", "continuous.chunk.prepare",
                 "continuous.chunk.retire"):
        assert all(a == {} for _, _, _, a in named(spans, name)), name


def test_span_yields_its_args():
    """What the body puts in the yielded dict is recorded at the close;
    the caller's dict is copied, and the null tracer records nothing."""
    tr, given = Tracer(), {"a": 1}
    with tr.span("x", args=given) as args:
        args["b"] = 2.5
    with tr.span("y") as args:
        pass
    evs = [e for e in tr.to_chrome()["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in evs] == ["x", "y"]
    assert evs[0]["args"] == {"a": 1, "b": 2.5} and given == {"a": 1}
    assert "args" not in evs[1]
    null = NullTracer()
    with null.span("z") as args:
        args["c"] = 1
    assert len(null) == 0


# ------------------------------------------------------- routing counts
def _counts(idx, E):
    return np.bincount(idx.reshape(-1), minlength=E)


def test_routing_counts_equal_a_numpy_count(moe_model, monkeypatch):
    """``pairs``, ``kept`` and ``experts_hit`` of every admission and
    chunk against a NumPy count of the experts ``moe._route`` chose:
    capacity ``int(T k cf / E)`` for a prompt (pairs really dropped),
    dropless for a one-token prompt and for decode, whose steps route
    every row, empty or not."""
    cfg, params = moe_model
    m, L = cfg.moe, cfg.n_layers
    chosen = []
    route = moe._route

    def spy(cfg_, p, x2d):
        out = route(cfg_, p, x2d)
        chosen.append(out[1].numpy().copy())
        return out
    monkeypatch.setattr(moe, "_route", spy)
    tr = Tracer()
    eng = ContinuousBatchingEngine(cfg, params, tracer=tr, **ENGINE)
    drain(eng, _requests(cfg.vocab_size))
    calls = iter(chosen)
    dropped = 0
    for name, _, _, a in wall(tr):
        if name == "continuous.admit.stats":
            idx = [next(calls) for _ in range(L)]
            T = idx[0].shape[0]
            C = (max(1, int(T * m.top_k * m.capacity_factor / m.n_experts))
                 if T > 1 else T)
            counts = [_counts(i, m.n_experts) for i in idx]
            want = {"pairs": T * m.top_k * L,
                    "kept": int(sum(np.minimum(c, C).sum() for c in counts)),
                    "experts_hit": int(sum((c > 0).sum() for c in counts))}
            assert a == want
            dropped += want["pairs"] - want["kept"]
        elif name == "continuous.chunk.stats":
            idx = [next(calls) for _ in range(L * eng.chunk)]
            assert all(i.shape == (eng.max_slots, m.top_k) for i in idx)
            assert a == {"pairs": eng.max_slots * m.top_k * L * eng.chunk,
                         "experts_hit": int(sum(
                             (_counts(i, m.n_experts) > 0).sum()
                             for i in idx))}
    assert next(calls, None) is None
    assert dropped > 0
    assert graph_hooks.transfer_counts()["continuous.routing"] == \
        len(named(wall(tr), "continuous.admit.stats")) \
        + len(named(wall(tr), "continuous.chunk.stats"))


def test_untraced_engine_installs_no_hook(model, traced, monkeypatch):
    """Without a tracer: every MoE layer finds no recorder installed, no
    count buffer or CUDA event is made, nothing extra is read back, and
    the tokens are the traced engine's."""
    cfg, params = model
    seen = []
    note = moe._note_routing

    def guard(group_sizes):
        assert not moe._ROUTING
        seen.append(1)
        note(group_sizes)

    def refuse(*a, **k):
        raise AssertionError("made on an untraced engine")
    monkeypatch.setattr(moe, "_note_routing", guard)
    monkeypatch.setattr(moe, "RoutingCounts", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    eng = ContinuousBatchingEngine(cfg, params, **ENGINE)
    done, _ = drain(eng, _requests(cfg.vocab_size))
    assert done == traced[3]
    assert bool(seen) == (cfg.backbone_kind == "moe")
    assert eng.tracer is None and eng._events == {} and eng._routing == {}
    assert eng._prefill_counts is None
    assert "continuous.routing" not in graph_hooks.transfer_counts()


def test_traced_cpu_engine_makes_no_event(moe_model, monkeypatch):
    """Device times come only from a CUDA device."""
    cfg, params = moe_model

    def refuse(*a, **k):
        raise AssertionError("a CUDA event on the CPU")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    eng = ContinuousBatchingEngine(cfg, params, tracer=Tracer(), **ENGINE)
    drain(eng, _requests(cfg.vocab_size))
    assert eng._events == {} and set(eng._routing) == {eng.chunk}


def test_routing_hook_restores_on_exit(moe_model):
    """``count_routing`` counts layers from 0 each time and leaves nothing
    installed; None installs nothing."""
    cfg, params = moe_model
    rec = moe.RoutingCounts(2, 4, "cpu")
    with moe.count_routing(None):
        assert not moe._ROUTING
    for _ in range(2):
        with moe.count_routing(rec):
            assert moe._ROUTING == [rec] and rec.layer == 0
            rec.note(torch.tensor([1, 0, 2, 0], dtype=torch.int32))
            rec.note(torch.tensor([0, 3, 0, 0], dtype=torch.int32))
        assert not moe._ROUTING
    assert rec.counts[:, 0].tolist() == [[1, 0, 2, 0], [0, 3, 0, 0]]
    step = torch.tensor(1)
    rec2 = moe.RoutingCounts(1, 4, "cpu", steps=3, step=step)
    with moe.count_routing(rec2):
        rec2.note(torch.tensor([5, 0, 0, 1], dtype=torch.int32))
    assert rec2.counts[0].tolist() == [[0] * 4, [5, 0, 0, 1], [0] * 4]


# -------------------------------------------------------- the readers
SPEC = harness.load_json(harness.HERE / "configs" / "deepseek-moe-16b.json")


def _ctx():
    """Two admissions and two decode chunks inside a window [0, 10) s, one
    of each outside it, and a profiler slice [1, 3] s over the first
    admission and the first chunk."""
    L, k = 28, 6
    chunk_pairs = 64 * k * L * 8
    spans = [
        ("continuous.admit", 1.0, 1.1, {"rows": 1, "S": 100}),
        ("continuous.admit.read", 1.07, 1.1, {}),
        ("continuous.admit.stats", 1.1, 1.1001,
         {"pairs": 100 * k * L, "kept": 100 * k * L - 300,
          "experts_hit": 64 * L}),
        ("continuous.chunk.prepare", 2.0, 2.002, {}),
        ("continuous.decode_chunk", 2.002, 2.252,
         {"chunk": 8, "occupancy": 64, "tokens_in_use": 9000}),
        ("continuous.chunk.stats", 2.252, 2.2521,
         {"first_step_ms": 36.0, "step_ms": 28.0, "pairs": chunk_pairs,
          "experts_hit": 8 * L * 64}),
        ("continuous.chunk.retire", 2.2521, 2.2551, {}),
        ("continuous.admit", 4.0, 4.2, {"rows": 1, "S": 300}),
        ("continuous.admit.read", 4.15, 4.2, {}),
        ("continuous.admit.stats", 4.2, 4.2001,
         {"pairs": 300 * k * L, "kept": 300 * k * L,
          "experts_hit": 60 * L}),
        ("continuous.chunk.prepare", 5.0, 5.004, {}),
        ("continuous.decode_chunk", 5.004, 5.254,
         {"chunk": 8, "occupancy": 64, "tokens_in_use": 9100}),
        ("continuous.chunk.stats", 5.254, 5.2541,
         {"first_step_ms": 34.0, "step_ms": 30.0, "pairs": chunk_pairs,
          "experts_hit": 8 * L * 63}),
        ("continuous.chunk.retire", 5.2541, 5.2591, {}),
        # after the close: read by no window metric
        ("continuous.admit.read", 11.0, 11.5, {}),
        ("continuous.admit.stats", 11.5, 11.6,
         {"pairs": 600, "kept": 0, "experts_hit": 1}),
        ("continuous.chunk.prepare", 11.6, 12.5, {}),
        ("continuous.decode_chunk", 12.5, 12.6,
         {"chunk": 8, "occupancy": 1, "tokens_in_use": 1}),
        ("continuous.chunk.stats", 12.6, 12.61,
         {"first_step_ms": 90.0, "step_ms": 1.0, "pairs": 1,
          "experts_hit": 1}),
    ]
    kernels = [("void ffn_gemm_64<true>", 1.01, 1.04),
               ("void ffn_reduce<bf16>", 1.04, 1.05),
               ("void flash_tc_128", 1.05, 1.06),
               ("void ffn_gemm_64<true>", 2.01, 2.09),
               ("void ffn_partial<bf16>", 2.09, 2.12),
               ("void paged_decode_split", 2.12, 2.2),
               ("void ffn_gemm_64<true>", 3.5, 3.6)]     # past the slice
    sl = Slice(1.0, 3.0, kernels, 0.5, [], [])
    return types.SimpleNamespace(spans=spans, profile=sl, t_open=0.0,
                                 t_close=10.0, spec=SPEC, seconds=10.0)


def _read(name, ctx):
    return harness.reader(name)(ctx)


@pytest.mark.parametrize("cell", ["paper", "docqa"])
def test_admit_read_ms_reader(cell):
    assert _read(f"admit_read_ms.{cell}", _ctx()) == \
        pytest.approx((30.0 + 50.0) / 2)


@pytest.mark.parametrize("cell", ["paper", "backlog"])
def test_decode_device_readers(cell):
    ctx = _ctx()
    assert _read(f"decode_step_device_ms.{cell}", ctx) == \
        pytest.approx(29.0)
    assert _read(f"decode_launch_wait_ms.{cell}", ctx) == \
        pytest.approx((8.0 + 4.0) / 2)
    # (2 + 3 ms) + (4 + 5 ms) of host work over two chunks
    assert _read(f"chunk_host_ms.{cell}", ctx) == pytest.approx(7.0)


def test_moe_dropped_pct_reader():
    pairs = (100 + 300) * 6 * 28
    assert _read("moe_dropped_pct.docqa", _ctx()) == \
        pytest.approx(100.0 * 300 / pairs)


def test_fused_ffn_roofline_readers():
    """By hand: an expert is 3 x 2048 x 1408 = 8,650,752 weights, the two
    shared experts 17,301,504; bf16, 3.35 TB/s, 989.4 TFLOP/s."""
    ctx = _ctx()
    # the chunk: 8 steps x 28 layers x 64 experts hit, 86,016 pairs,
    # 14,336 shared rows, 224 (layer, step)s
    nbytes = 2 * (14_336 * 8_650_752 + 224 * 17_301_504
                  + 2 * 2048 * (86_016 + 14_336))
    flops = 2 * (86_016 * 8_650_752 + 14_336 * 17_301_504)
    bound = max(nbytes / 3.35e12, flops / 989.4e12)
    took = 0.08 + 0.03             # ffn_gemm and ffn_partial in the chunk
    assert nbytes / 3.35e12 > flops / 989.4e12
    assert _read("fused_ffn_roofline.backlog", ctx) == \
        pytest.approx(100.0 * bound / took)
    # the first admission: 16,500 kept pairs, 2,800 shared rows, 28 layers
    kept, rows = 100 * 6 * 28 - 300, 100 * 28
    nbytes = 2 * (64 * 28 * 8_650_752 + 28 * 17_301_504
                  + 2 * 2048 * (kept + rows))
    flops = 2 * (kept * 8_650_752 + rows * 17_301_504)
    bound = max(nbytes / 3.35e12, flops / 989.4e12)
    assert _read("fused_ffn_roofline.docqa", ctx) == \
        pytest.approx(100.0 * bound / 0.04)


@pytest.mark.parametrize("name", [
    "admit_read_ms.paper", "admit_read_ms.docqa",
    "decode_step_device_ms.paper", "decode_step_device_ms.backlog",
    "decode_launch_wait_ms.paper", "decode_launch_wait_ms.backlog",
    "chunk_host_ms.paper", "chunk_host_ms.backlog",
    "fused_ffn_roofline.backlog", "fused_ffn_roofline.docqa",
    "moe_dropped_pct.docqa"])
def test_readers_find_nothing_without_the_phases(name):
    """A program that records only the two older spans (as the JAX
    engine's and the port before them): every new reader gives None."""
    ctx = _ctx()
    ctx.spans = [s for s in ctx.spans
                 if s[0] in ("continuous.admit", "continuous.decode_chunk")]
    assert _read(name, ctx) is None
    ctx.profile = None
    assert _read(name, ctx) is None


# ------------------------------------------------------------ the card
def _card_engine(**kw):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's Hopper kernels)")
    cfg = dataclasses.replace(_config("deepseek-moe-16b"),
                              dtype="bfloat16")
    params = init_params(cfg, 0, "cuda")
    return cfg, ContinuousBatchingEngine(cfg, params, max_slots=4,
                                         capacity=256, chunk=8, paged=True,
                                         **kw)


@pytest.mark.cuda
def test_device_step_times_within_the_chunk_span():
    """On the card: each replayed chunk's ``step_ms`` is at most its wall
    span over its steps, and ``first_step_ms`` (the first step and its
    launch wait) at least ``step_ms``; a chunk that captures gives none."""
    tr = Tracer()
    cfg, eng = _card_engine(tracer=tr)
    rng = np.random.default_rng(3)
    drain(eng, [(i, rng.integers(1, cfg.vocab_size, 24), 40, 1)
                for i in range(6)])
    spans = wall(tr)
    timed = 0
    for i, p in enumerate(named(spans, "continuous.decode_chunk")):
        a = [s for s in spans if s[1] >= p[2]][0][3]
        if i == 0:
            assert "step_ms" not in a        # captured its graph
            continue
        assert a["step_ms"] <= 1e3 * (p[2] - p[1]) / p[3]["chunk"]
        assert a["first_step_ms"] >= a["step_ms"]
        assert a["first_step_ms"] + 7 * a["step_ms"] \
            <= 1e3 * (p[2] - p[1])
        assert a["experts_hit"] > 0
        timed += 1
    assert timed > 0


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [False, True])
def test_prefill_enqueue_waits_for_no_stream(traced, monkeypatch):
    """On the card: from the prefill's ``forward`` to the first tokens'
    read nothing waits for the stream (CUDA's sync debug mode raises on
    any call that would), so ``continuous.admit.read`` holds the device's
    tail of the prefill. Prompts of 1, 24 and 200 tokens, once each
    unchecked first so that every kernel is built."""
    from repro_torch.serving import continuous
    cfg, eng = _card_engine(tracer=Tracer() if traced else None)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (1, 24, 200)]
    drain(eng, [(i, x, 2, 1) for i, x in enumerate(prompts)])
    forward, to_host, checked = continuous.forward, graph_hooks.to_host, []

    def strict_forward(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        checked.append(1)
        return forward(*a, **k)

    def lenient_read(x, label):
        torch.cuda.set_sync_debug_mode("default")
        return to_host(x, label)
    monkeypatch.setattr(continuous, "forward", strict_forward)
    monkeypatch.setattr(graph_hooks, "to_host", lenient_read)
    try:
        flags = eng.admit_many([(10 + i, x, 2, 1)
                                for i, x in enumerate(prompts)])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(flags) and len(checked) == len(prompts)
