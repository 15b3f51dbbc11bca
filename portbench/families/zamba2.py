"""The ``zamba2`` family (Zamba2 as published): a configuration file's
published keys -> the port's ``Zamba2Config`` and the parameter tree's
leaves, in the port's layout (the Mamba2 layers' leaves stacked on the
layer axis; the shared blocks and the applications' adapters and
linears unstacked, each with its own leading axis, drawn whole).

Where a plain normal draw would be degenerate, a leaf follows the
published init (``transformers``' ``Zamba2PreTrainedModel._init_weights``):
``A_log = log(1 .. nh)``, ``dt_bias`` the inverse softplus of a step size
log-uniform in ``[time_step_min, time_step_max]`` (floored at
``time_step_floor``), ``D`` ones. ``weights.draw`` multiplies a leaf's
seeded normal noise by its ``std`` in place; for these leaves ``std`` is
a :class:`Init`, which takes that product over (``__torch_function__``)
and writes the init's values instead, from the same noise.
"""
from __future__ import annotations

import math

import torch

from ..weights import Leaf

#: published keys whose values the port's Zamba2 has no other setting for
FIXED = {"add_bias_linear": False, "use_conv_bias": True,
         "hidden_act": "gelu", "use_mem_rope": True,
         "use_shared_attention_adapter": False,
         "use_shared_mlp_adapter": True, "use_long_context": False,
         "time_step_limit": None, "model_type": "zamba2"}


class Init:
    """A leaf's ``std`` that makes its draw ``fn(noise)``: ``noise`` the
    leaf's seeded N(0, 1) draw in f32."""

    def __init__(self, fn):
        self.fn = fn

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        noise, init = args                  # weights.draw: noise.mul_(std)
        return noise.copy_(init.fn(noise))


def _a_log(noise: torch.Tensor) -> torch.Tensor:
    nh = noise.shape[-1]
    return torch.log(torch.arange(1, nh + 1, dtype=noise.dtype,
                                  device=noise.device)).expand_as(noise)


def _dt_bias(spec: dict):
    lo, hi = math.log(spec["time_step_min"]), math.log(spec["time_step_max"])
    floor = spec["time_step_floor"]

    def fn(noise):
        u = torch.special.ndtr(noise)                 # uniform in (0, 1)
        dt = torch.exp(u * (hi - lo) + lo).clamp(min=floor)
        return dt + torch.log(-torch.expm1(-dt))      # softplus^-1
    return fn


def port_config(spec: dict):
    """The configuration as the port runs it. Where the file names the
    port's own id (``port_arch``), every field has to agree with it."""
    import dataclasses

    from repro_torch.models.config import GroupedSSMConfig, Zamba2Config
    for k, v in FIXED.items():
        if spec[k] != v:
            raise ValueError(f"the port's Zamba2 runs {k}={v!r}, the file "
                             f"gives {spec[k]!r}")
    d, nh = spec["hidden_size"], spec["num_attention_heads"]
    ids = tuple(spec["hybrid_layer_ids"])
    kinds = spec["layers_block_type"]
    if (len(kinds) != spec["num_hidden_layers"]
            or ids != tuple(i for i, k in enumerate(kinds) if k == "hybrid")
            or spec["attention_hidden_size"] != 2 * d
            or spec["attention_head_dim"] * nh != 2 * d
            or spec["n_mamba_heads"] * spec["mamba_headdim"]
            != spec["mamba_expand"] * d
            or spec["ffn_hidden_size"] != spec["intermediate_size"]):
        raise ValueError("the file's shapes do not agree with each other")
    ssm = GroupedSSMConfig(d_state=spec["mamba_d_state"],
                           d_conv=spec["mamba_d_conv"],
                           expand=spec["mamba_expand"],
                           head_dim=spec["mamba_headdim"],
                           chunk=spec["chunk_size"],
                           n_groups=spec["mamba_ngroups"],
                           dt_min=spec["time_step_min"])
    cfg = Zamba2Config(
        arch_id=spec.get("port_arch", "portbench-zamba2"), family="hybrid",
        n_layers=spec["num_hidden_layers"], d_model=d, n_heads=nh,
        n_kv_heads=spec["num_key_value_heads"],
        head_dim=spec["attention_head_dim"], d_ff=spec["intermediate_size"],
        vocab_size=spec["vocab_size"], rope_theta=spec["rope_theta"],
        tie_embeddings=spec["assumed"]["tie_word_embeddings"], ssm=ssm,
        hybrid_layer_ids=ids, num_mem_blocks=spec["num_mem_blocks"],
        adapter_rank=spec["adapter_rank"],
        attn_scale=(spec["attention_head_dim"] / 2) ** -0.5,
        norm_eps=spec["rms_norm_eps"],
        dtype=spec["torch_dtype"], source=spec.get("source", ""))
    cfg.validate(paged=True)
    if "port_arch" in spec:
        from repro_torch.configs import get_config
        ref = get_config(spec["port_arch"])
        mine, theirs = dataclasses.asdict(cfg), dataclasses.asdict(ref)
        diff = {k: (mine[k], theirs[k]) for k in mine.keys() | theirs.keys()
                if k != "source" and mine.get(k) != theirs.get(k)}
        if diff or type(cfg) is not type(ref) \
                or type(cfg.ssm) is not type(ref.ssm):
            raise ValueError(f"the file departs from the port's "
                             f"{spec['port_arch']}: {diff}")
    return cfg


def leaves(spec: dict) -> list:
    d, V = spec["hidden_size"], spec["vocab_size"]
    nh, nkv = spec["num_attention_heads"], spec["num_key_value_heads"]
    hd, f = spec["attention_head_dim"], spec["intermediate_size"]
    d_in = spec["mamba_expand"] * d
    mh, K = spec["n_mamba_heads"], spec["mamba_d_conv"]
    bc = 2 * spec["mamba_ngroups"] * spec["mamba_d_state"]
    M, A = spec["num_mem_blocks"], len(spec["hybrid_layer_ids"])
    r = spec["adapter_rank"]
    w = spec["weights"]
    out = w["out_scale"]
    # the embedding's rows of norm about 1, as the head's columns of an
    # untied model: the head is tied to it
    tree = [Leaf(("embed", "tok"), (V, d), d ** -0.5, False),
            Leaf(("final_norm", "scale"), (d,), None, False)]
    blk = [(("ln1", "scale"), (d,), None),
           (("mamba", "z_proj"), (d, d_in), d ** -0.5),
           (("mamba", "x_proj"), (d, d_in), d ** -0.5),
           (("mamba", "bc_proj"), (d, bc), d ** -0.5),
           (("mamba", "dt_proj"), (d, mh), d ** -0.5),
           (("mamba", "conv_x"), (K, d_in), K ** -0.5),
           (("mamba", "conv_bc"), (K, bc), K ** -0.5),
           (("mamba", "conv_b_x"), (d_in,), w["conv_bias"]),
           (("mamba", "conv_b_bc"), (bc,), w["conv_bias"]),
           (("mamba", "A_log"), (mh,), Init(_a_log)),
           (("mamba", "D"), (mh,), None),
           (("mamba", "dt_bias"), (mh,), Init(_dt_bias(spec))),
           (("mamba", "norm"), (d_in,), None),
           (("mamba", "out_proj"), (d_in, d), out * d_in ** -0.5)]
    shared = [(("shared", "ln1", "scale"), (M, 2 * d), None),
              (("shared", "attn", "wq"), (M, 2 * d, nh * hd),
               (2 * d) ** -0.5),
              (("shared", "attn", "wk"), (M, 2 * d, nkv * hd),
               (2 * d) ** -0.5),
              (("shared", "attn", "wv"), (M, 2 * d, nkv * hd),
               (2 * d) ** -0.5),
              (("shared", "attn", "wo"), (M, nh * hd, d), (nh * hd) ** -0.5),
              (("shared", "ln2", "scale"), (M, d), None),
              (("shared", "mlp", "gate_up"), (M, d, 2 * f), d ** -0.5),
              (("shared", "mlp", "down"), (M, f, d), f ** -0.5),
              (("apps", "lora_a"), (A, d, r), d ** -0.5),
              (("apps", "lora_b"), (A, r, 2 * f), r ** -0.5),
              (("apps", "linear"), (A, d, d), d ** -0.5)]
    return (tree + [Leaf(p, s, std, False) for p, s, std in shared]
            + [Leaf(("blocks",) + p, s, std, True) for p, s, std in blk])
