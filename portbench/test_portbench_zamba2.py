"""The ``zamba2`` family (Zamba2 as published) on the CPU at a tiny size:
a cell defined only here through ``harness.run``, the fp8 control coming
out as not correct, the family's config held to the port's id,
``roofline_zamba2``'s counts by hand, and the reference's imports."""
import json
import math

import pytest
import torch

from repro_torch.compat import cap_xdist_threads

from portbench import harness, imports, roofline_zamba2 as rz, tiny
from portbench.families import zamba2 as fam

cap_xdist_threads()

CELL = "tiny-zamba2.deep.backlog"
SPEC = harness.load_json(harness.HERE / "configs" / "zamba2-7b.json")


@pytest.fixture(autouse=True)
def _jax_elsewhere(monkeypatch):
    # another test file in this worker may have loaded JAX, which a run
    # refuses; the check itself is held in test_portbench_imports.py
    monkeypatch.setattr(imports, "forbidden_loaded", lambda modules=None: [])


def tiny_spec() -> dict:
    """d 64, 8 layers, shared blocks before 1, 3, 4 and 6 (two blocks in
    turn), 4 heads of 32 over the 128-wide [h, x0], 8 SSD heads of 16 in
    2 groups, adapters of rank 8, f32."""
    s = json.loads(json.dumps(SPEC))
    s.pop("port_arch")
    ids, L = [1, 3, 4, 6], 8
    s.update(hidden_size=64, num_hidden_layers=L, num_attention_heads=4,
             num_key_value_heads=4, attention_hidden_size=128,
             attention_head_dim=32, kv_channels=16, num_query_groups=4,
             intermediate_size=96, ffn_hidden_size=96, n_mamba_heads=8,
             mamba_headdim=16, mamba_d_state=16, adapter_rank=8,
             vocab_size=256, chunk_size=8, torch_dtype="float32",
             hybrid_layer_ids=ids,
             layers_block_type=["hybrid" if i in ids else "mamba"
                                for i in range(L)])
    # eight layers: full-size blocks, so that what they compute shows
    s["weights"]["out_scale"] = 1.0
    return s


def make(base, cell=CELL) -> dict:
    """A tiny backlog cell of the zamba2 family under ``base``, with the
    metrics of ``zamba2-7b.deep.backlog``."""
    bench = tiny.make(base, cell)
    real = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for kind in ("end_to_end", "per_layer"):
        for m, r in zip(bench[kind], real[kind]):
            if "workloads" in m:
                m["workloads"] = ([cell] if "zamba2-7b.deep.backlog"
                                  in r["workloads"] else [])
    (base / "configs" / "tiny.json").write_text(json.dumps(tiny_spec()))
    c = tiny.cell()
    c["engine"].update(n_blocks=20)
    c["arrivals"] = {"mode": "backlog", "requests": 200, "warm_chunks": 2}
    (base / "cells" / f"{cell}.json").write_text(json.dumps(c))
    return bench


def run(tmp_path, trace=False, **kw):
    bench = make(tmp_path)
    return harness.run(CELL, 2**32 + 17, 1.0, trace, t_process=0.0,
                       bench=bench, base=tmp_path, device="cpu", **kw)


@pytest.mark.parametrize("control", [False, True])
def test_tiny_cell_correct_and_control_not(tmp_path, control):
    res, checks = run(tmp_path, control=control)
    assert res["correct"] is (not control), res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    if control:
        assert {c.name for c in checks if not c.ok} == {"max_logit_gap",
                                                        "mean_logit_gap"}
    else:
        assert res["checks"]["backlog_queue_empty"]["value"] == 0
        assert {"tokens_per_s", "setup_s"} <= set(res["metrics"])


def test_tiny_cell_traced(tmp_path):
    res, _ = run(tmp_path, trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    for name in ("mfu.zamba2.backlog", "slots_active_mean.backlog",
                 "decode_step_ms.backlog"):
        assert math.isfinite(m[name]["value"]), name
    # the device's step and phase times exist on a card only
    for name in ("mamba_decode_ms.zamba2.backlog",
                 "mamba_state_roofline.zamba2.backlog",
                 "paged_decode_attention_roofline.zamba2.backlog"):
        assert name not in m


def test_the_file_is_the_ports_id():
    cfg = fam.port_config(SPEC)
    assert cfg.arch_id == "zamba2-7b-instruct" and cfg.n_apps == 13
    assert cfg.param_count() == 7_355_225_088
    for key, value in (("mamba_ngroups", 1), ("num_mem_blocks", 1),
                       ("adapter_rank", 64), ("rms_norm_eps", 1e-6),
                       ("time_step_min", 0.0), ("hidden_act", "silu")):
        with pytest.raises(ValueError):
            fam.port_config({**SPEC, key: value})
    for key in fam.FIXED:
        with pytest.raises(ValueError):
            fam.port_config({**SPEC, key: "other"})


def test_published_init_leaves():
    from portbench import weights
    leaves = fam.leaves(tiny_spec())
    i, a_log = next((i, x) for i, x in enumerate(leaves)
                    if x.path == ("blocks", "mamba", "A_log"))
    got = weights.draw(a_log, i, 3, 0, torch.float32, "cpu")
    assert torch.allclose(got, torch.log(torch.arange(1.0, 9.0)))
    i, bias = next((i, x) for i, x in enumerate(leaves)
                   if x.path == ("blocks", "mamba", "dt_bias"))
    dt = torch.nn.functional.softplus(
        weights.draw(bias, i, 3, 2, torch.float32, "cpu"))
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)


def test_roofline_counts_by_hand():
    """Zamba2-7B: a Mamba2 layer's projections 3584 x (2 x 7168 + 256 +
    112) + 7168 x 3584 = 78,389,248; an application's 7168 x (32 + 64) x
    224 + 7168 x 3584 + 3 x 3584 x 14336 + 128 x (3584 + 28672) + 3584^2
    = 350,945,280; 13 x 4 x 32 x 224 FLOPs and 13 x 2 x 32 x 224 x 2
    bytes a cached position; 81 x (112 x 64 x 64 x 4 + 3 x 7424 x 2)
    bytes of state a row."""
    assert rz.mamba_matmul_params(SPEC) == 78_389_248
    assert rz.shared_app_params(SPEC) == 350_945_280
    assert rz.attention_flops_per_position(SPEC) == 372_736
    assert rz.kv_bytes_per_position(SPEC) == 372_736
    assert rz.state_bytes_per_row(SPEC) == 81 * (112 * 64 * 64 * 4
                                                 + 3 * 7424 * 2)
    mamba = 81 * 2.0 * (78_389_248 + 4 * 7424 + 112 * 64 * 64)
    token = (mamba + 2.0 * 13 * 350_945_280 + 2.0 * 3584 * 32000
             + 372_736 * 100)
    assert rz.decode_token_flops(SPEC, 100) == pytest.approx(token)
    weights = 81 * 2 * (78_389_248 + 5 * 7424 + 3 * 112 + 7168 + 3584)
    assert rz.mamba_weight_bytes(SPEC) == weights
    assert rz.mamba_step_bytes(SPEC, 64) == weights + 2 * 64 * \
        rz.state_bytes_per_row(SPEC)
    flops, nbytes = rz.decode_attention_cost(SPEC, [10, 30])
    assert flops == 372_736 * 40
    assert nbytes == 372_736 * 40 + 13 * 2 * 2 * 32 * 224 * 2
    assert rz.bound_s(flops, nbytes) == nbytes / 3.35e12


def test_reference_imports_nothing_of_the_program():
    path = harness.HERE / "reference" / "zamba2.py"
    names = imports.imported(path)
    assert not names & (imports.FORBIDDEN | imports.PROGRAM)
    assert not imports.imported(harness.HERE / "roofline_zamba2.py") & (
        imports.FORBIDDEN | imports.PROGRAM)


def _ctx(spans, spec=SPEC):
    import types
    return types.SimpleNamespace(spans=spans, profile=None, t_open=0.0,
                                 t_close=10.0, spec=spec, seconds=10.0,
                                 loop=types.SimpleNamespace(chunks=[]))


def test_phase_readers_by_hand():
    """Two chunks' stats (the first with a 64-row step of 50 ms of Mamba2
    layers, the second 40 ms), one outside the window, one without the
    phase times: the mean, and the Mamba2 layers' bound over their
    time."""
    stats = "continuous.chunk.stats"
    spans = [(stats, 1.0, 1.1, {"mamba_ms": 50.0, "shared_ms": 9.0,
                                "state_rows": 64, "kv_blocks": 100}),
             (stats, 2.0, 2.1, {"mamba_ms": 40.0, "shared_ms": 9.0,
                                "state_rows": 64, "kv_blocks": 120}),
             (stats, 3.0, 3.1, {"state_rows": 64}),
             (stats, 11.0, 11.1, {"mamba_ms": 99.0, "state_rows": 64})]
    assert harness.reader("mamba_decode_ms.zamba2.backlog")(
        _ctx(spans)) == pytest.approx(45.0)
    bound = rz.mamba_step_bytes(SPEC, 64) / 3.35e12
    assert bound > rz.mamba_step_flops(SPEC, 64) / 989.4e12
    assert harness.reader("mamba_state_roofline.zamba2.backlog")(
        _ctx(spans)) == pytest.approx(100.0 * 2 * bound / 0.09)
    # a program without the phase times, and another family's cell
    bare = [s[:3] + ({"state_rows": 64},) for s in spans]
    for name in ("mamba_decode_ms.zamba2.backlog",
                 "mamba_state_roofline.zamba2.backlog"):
        assert harness.reader(name)(_ctx(bare)) is None
    moe = harness.load_json(harness.HERE / "configs" / "deepseek-moe-16b.json")
    for name in ("mamba_state_roofline.zamba2.backlog", "mfu.zamba2.backlog",
                 "paged_decode_attention_roofline.zamba2.backlog"):
        assert harness.reader(name)(_ctx(spans, moe)) is None
