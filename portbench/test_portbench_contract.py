"""BENCHMARK.json against the benchmark's own rules: its keys, names,
units and limits, and every name found as a file."""
import json
import re

import pytest

from portbench import harness

B = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def one_line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["portbench"]
    assert B["command"][1].startswith("portbench/")
    assert all(one_line(w) for w in B["command"])
    assert 1 <= B["run_seconds"] <= 51
    # a full check with 24 cells fits in its allowance
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(B)) <= 64 * 1024


def test_configs():
    used = {w["config"] for w in B["workloads"]}
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        spec = harness.load_json(harness.ROOT / c["file"])
        assert spec["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in spec
            assert not re.search(r"(_dim|_rank|size|hidden|heads|experts"
                                 r"_per_tok)$", k)
            assert spec["published"][k] != spec[k]
        assert one_line(c["why"]) and one_line(c["source"])


def test_workloads_and_files():
    names = [w["name"] for w in B["workloads"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and one_line(w["why"])
        f = harness.find(B, w["name"])
        assert f["cell"]["engine"]["chunk"] == 8
        if f["cell"]["arrivals"]["mode"] == "poisson":
            assert f["cell"]["arrivals"]["rate"] == pytest.approx(
                0.8 * f["cell"]["arrivals"]["knee"], rel=0.02)


def test_metrics():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in e2e
        for w in m["workloads"]:
            assert harness.applies(e2e[m["moves"]], w)
        if m["unit"] == "%":
            layers.setdefault(m["layer"], []).append(m["name"])
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in B["workloads"]}
    for w in B["workloads"]:
        mine = [m for m in B["end_to_end"] if harness.applies(m, w["name"])]
        assert len(mine) >= 2
        assert any(harness.applies(m, w["name"]) for m in B["per_layer"])
    # a kernel's roofline share comes with a whole step's share of the
    # peak that moves the same end-to-end metric
    for m in B["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert any("mfu" in x["name"] and x["moves"] == m["moves"]
                       for x in B["per_layer"])
