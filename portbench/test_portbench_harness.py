"""The harness on the CPU at a tiny size: discovery of a configuration,
mix, cell and metric by file name, the result line, the comparison with
the plain reference, and the faults that it has to catch."""
import json
import math

import pytest
import torch

from repro_torch.compat import cap_xdist_threads

from portbench import harness, tiny

cap_xdist_threads()


@pytest.fixture(autouse=True)
def _jax_elsewhere(monkeypatch):
    # another test file in this worker may have loaded JAX, which a run
    # refuses; the check itself is held in test_portbench_imports.py
    from portbench import imports
    monkeypatch.setattr(imports, "forbidden_loaded", lambda modules=None: [])


def run(tmp_path, trace=False, seconds=1.0, cell=tiny.CELL, **kw):
    bench = tiny.make(tmp_path, cell)
    return harness.run(cell, 2**32 + 11, seconds, trace, t_process=0.0,
                       bench=bench, base=tmp_path, device="cpu", **kw)


def test_a_throwaway_cell_runs_from_its_files_alone(tmp_path):
    # a cell, configuration, mix and metric defined only here, found by
    # their names
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "requests_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx.requests))\n")
    bench = tiny.make(tmp_path, "throwaway.cell")
    bench["end_to_end"].append({"name": "requests_seen", "unit": "requests",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["throwaway.cell"]})
    res, checks = harness.run("throwaway.cell", 3, 1.0, False,
                              t_process=0.0, bench=bench, base=tmp_path,
                              device="cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"]["requests_seen"]["value"] > 0
    assert {"tokens_per_s",
            "system_time_mean_s", "setup_s"} <= set(res["metrics"])
    assert list(res)[-1] == "checks"
    assert {c.name for c in checks} >= {"max_logit_gap", "budgets_off"}


def test_traced_run_reads_the_per_layer_metrics(tmp_path):
    res, _ = run(tmp_path, trace=True, seconds=1.0)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    for cell in ("paper", "docqa"):
        for name in ("ttft_p90_ms", "tpot_p90_ms", "admit_prefill_ms",
                     "decode_step_ms", "admit_wait_ms", "mfu.prefill"):
            assert math.isfinite(m[f"{name}.{cell}"]["value"]), name
    for name in ("system_time_mean_s.paper",
                 "slots_active_mean.backlog", "mfu.backlog"):
        assert name in m and math.isfinite(m[name]["value"]), name
    assert "breakdown" in res and "window_s" in res["device"]
    # the window's own host-clock readings, beside the traced slice's
    assert set(res["notes"]["window"]) == {
        "ttft_p90_ms", "tpot_p90_ms", "system_time_mean_s"}
    # no kernel ran on a card: no roofline share is reported
    assert "paged_decode_attention_roofline" not in m
    assert "flash_attention_roofline" not in m
    json.dumps(res)


def test_no_card_no_result(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bench = tiny.make(tmp_path)
    with pytest.raises(harness.NoDevice):
        harness.run(tiny.CELL, 1, 1.0, False, t_process=0.0, bench=bench,
                    base=tmp_path)


@pytest.mark.parametrize("control", [False, True])
def test_program_matches_reference_and_control_does_not(tmp_path, control):
    # the control, the reference with float8 linear layers, stands in the
    # program's place and has to come out as not correct
    res, checks = run(tmp_path, control=control)
    assert res["correct"] is (not control), res["checks"]
    failed = {c.name for c in checks if not c.ok}
    if control:
        assert failed == {"max_logit_gap", "mean_logit_gap"}
        prog = res["notes"]["program"]
        assert prog["max_logit_gap"] <= res["checks"]["max_logit_gap"][
            "limit"]
    else:
        assert not failed


def test_probe_reads_every_side(tmp_path):
    res, _ = run(tmp_path, probe=True)
    gaps = res["notes"]["gaps"]
    assert set(gaps) == {"program", "control", "served"}
    for g in gaps.values():
        assert g["n"] == res["notes"]["sampled_tokens"] > 0
        assert len(g["above_0"]) == round(g["off_top_share"] * g["n"] / 100)
    assert res["correct"], res["checks"]


def _bad_token(monkeypatch):
    from repro_torch.serving import continuous
    orig = continuous.ContinuousBatchingEngine._next_tokens

    def altered(self, logits, rids, gidx):
        out = orig(self, logits, rids, gidx)
        return torch.where(gidx == 3, (out + 1) % logits.shape[-1], out)
    monkeypatch.setattr(continuous.ContinuousBatchingEngine, "_next_tokens",
                        altered)


def _state_unchanged(monkeypatch):
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "_advance", lambda cache: cache)


def _half_batch(monkeypatch):
    from repro_torch.models import moe
    orig = moe.moe_apply

    def half(cfg, p, x, force_ref=False):
        # the second half of the rows (a prefill's positions, a decode
        # step's slots) left out of the FFN
        y, probs, idx = orig(cfg, p, x, force_ref=force_ref)
        B, S, d = y.shape
        flat = y.reshape(B * S, d).clone()
        flat[B * S // 2:] = 0
        return flat.view(B, S, d), probs, idx
    monkeypatch.setattr(moe, "moe_apply", half)


def _budget(monkeypatch):
    from repro_torch.serving import scheduler
    orig = scheduler.Scheduler.admit

    def admit(self, req, now, observe=True, budget_cap=None):
        orig(self, req, now, observe=observe, budget_cap=budget_cap)
        req.budget += 1
    monkeypatch.setattr(scheduler.Scheduler, "admit", admit)


@pytest.mark.parametrize("fault", [_bad_token, _state_unchanged,
                                   _half_batch, _budget])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    res, _ = run(tmp_path, seconds=1.5)
    assert not res["correct"], res["checks"]
