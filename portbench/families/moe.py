"""The ``moe`` family (DeepSeek-MoE style): a configuration file's
published keys -> the port's ``ModelConfig`` and the parameter tree's
leaves, in the port's layout (per-layer leaves stacked on a leading layer
axis, routed experts stacked for one launch)."""
from __future__ import annotations

from ..weights import Leaf

#: the port's ModelConfig fields, each from the published key beside it
FIELDS = {"n_layers": "num_hidden_layers", "d_model": "hidden_size",
          "n_heads": "num_attention_heads",
          "n_kv_heads": "num_key_value_heads",
          "vocab_size": "vocab_size", "rope_theta": "rope_theta"}


def port_config(spec: dict):
    """The configuration as the port runs it. Where the file names the
    port's own id (``port_arch``), every field has to agree with it."""
    import dataclasses

    from repro_torch.models.config import ModelConfig, MoEConfig
    moe = MoEConfig(n_experts=spec["n_routed_experts"],
                    top_k=spec["num_experts_per_tok"],
                    n_shared_experts=spec["n_shared_experts"],
                    d_expert=spec["moe_intermediate_size"],
                    impl=spec["moe_dispatch"],
                    capacity_factor=spec["moe_capacity_factor"])
    if spec["first_k_dense_replace"] != 0 or not spec["norm_topk_prob"]:
        raise ValueError("the port's MoE makes every layer MoE and "
                         "renormalises the top-k weights")
    cfg = ModelConfig(arch_id=spec.get("port_arch", "portbench-moe"),
                      family="moe", d_ff=spec["moe_intermediate_size"],
                      moe=moe, dtype=spec["torch_dtype"],
                      source=spec.get("source", ""),
                      **{f: spec[k] for f, k in FIELDS.items()})
    if "port_arch" in spec:
        from repro_torch.configs import get_config
        ref = get_config(spec["port_arch"])
        mine, theirs = dataclasses.asdict(cfg), dataclasses.asdict(ref)
        diff = {k: (mine[k], theirs[k]) for k in mine
                if k != "source" and mine[k] != theirs[k]}
        if diff:
            raise ValueError(f"the file departs from the port's "
                             f"{spec['port_arch']}: {diff}")
    return cfg


def leaves(spec: dict) -> list:
    d = spec["hidden_size"]
    nh, nkv = spec["num_attention_heads"], spec["num_key_value_heads"]
    hd = spec.get("head_dim") or d // nh
    E, f = spec["n_routed_experts"], spec["moe_intermediate_size"]
    fs = f * spec["n_shared_experts"]
    V = spec["vocab_size"]
    gain = spec["weights"]["router_gain"]
    # the blocks' output projections, as GPT-2 scales them: 1/sqrt(2 L)
    out = spec["weights"]["out_scale"]
    tree = [Leaf(("embed", "tok"), (V, d), 1.0, False),
           Leaf(("embed", "head"), (d, V), d ** -0.5, False),
           Leaf(("final_norm", "scale"), (d,), None, False)]
    blk = [(("ln1", "scale"), (d,), None),
           (("attn", "wq"), (d, nh * hd), d ** -0.5),
           (("attn", "wk"), (d, nkv * hd), d ** -0.5),
           (("attn", "wv"), (d, nkv * hd), d ** -0.5),
           (("attn", "wo"), (nh * hd, d), out * (nh * hd) ** -0.5),
           (("ln2", "scale"), (d,), None),
           (("moe", "router"), (d, E), gain * d ** -0.5),
           (("moe", "w_gate"), (E, d, f), d ** -0.5),
           (("moe", "w_up"), (E, d, f), d ** -0.5),
           (("moe", "w_down"), (E, f, d), out * f ** -0.5)]
    if fs:
        blk += [(("moe", "shared", "gate"), (d, fs), d ** -0.5),
                (("moe", "shared", "up"), (d, fs), d ** -0.5),
                (("moe", "shared", "down"), (fs, d), out * fs ** -0.5)]
    return tree + [Leaf(("blocks",) + p, s, std, True) for p, s, std in blk]
