"""A throwaway benchmark at a tiny size, in a directory of its own, for the
CPU tests: the same harness, files and readers, on the port's plain
versions (no card)."""
from __future__ import annotations

import json
import pathlib
import shutil

from .harness import HERE, load_json

CELL = "tiny.paper.poisson"


def spec() -> dict:
    s = load_json(HERE / "configs" / "deepseek-moe-16b.json")
    s.pop("port_arch")
    s.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=4, moe_intermediate_size=32,
             n_routed_experts=4, num_experts_per_tok=2, n_shared_experts=1,
             vocab_size=256, torch_dtype="float32")
    # two layers: full-size blocks, so that what they compute shows
    s["weights"]["out_scale"] = 1.0
    return s


def mix() -> dict:
    m = load_json(HERE / "mixes" / "paper.json")
    m["problem"]["l_max"] = 12.0
    m["prompt_len"] = {"dist": "uniform", "lo": 4, "hi": 24}
    return m


def cell() -> dict:
    return {"engine": {"paged": True, "max_slots": 4, "capacity": 48,
                       "block_size": 8, "n_blocks": 24, "chunk": 4},
            "arrivals": {"mode": "poisson", "rate": 6.0, "warm_s": 0.5},
            "profile": {"after_close_s": 0.1, "length_s": 0.3},
            "check": {"sample": 3, "max_logit_gap": 1e-3,
                      "mean_logit_gap": 1e-4}}


def make(base: pathlib.Path, cell_name: str = CELL) -> dict:
    """Write the tiny benchmark's files under ``base`` (the metric readers
    copied from this package) and return its BENCHMARK.json."""
    for sub in ("configs", "mixes", "cells"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(HERE / "metrics", base / "metrics", dirs_exist_ok=True)
    (base / "configs" / "tiny.json").write_text(json.dumps(spec()))
    (base / "mixes" / "tiny-paper.json").write_text(json.dumps(mix()))
    (base / "cells" / f"{cell_name}.json").write_text(json.dumps(cell()))
    bench = load_json(HERE.parent / "BENCHMARK.json")
    bench["workloads"] = [{"name": cell_name, "config": "tiny",
                           "traffic": "tiny-paper", "chips": 1,
                           "why": "CPU test"}]
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if "workloads" in m:
                m["workloads"] = [cell_name]
    return bench
