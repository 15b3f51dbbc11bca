"""Plain PyTorch forward of the ``moe`` family, in float32, layer by layer.

DeepSeek-MoE's decoder as the port serves it: RMS norm (eps 1e-6) before
attention and before the FFN; full causal multi-head attention with RoPE
(theta from the file; the rotation of the two halves of each head);
softmax routing in f32 over the routed experts, top-k, the k weights
renormalised to sum to one; SwiGLU experts, plus the always-on shared
experts as one SwiGLU of their summed width; a final RMS norm and an
untied head. Departures from the published model, which the port makes
and this reference follows, are listed in the configuration file
(``departures``): every layer is MoE, the top-k weights are renormalised,
and a prompt's prefill dispatches by capacity. For that last one the
positions of the prompt route as one group of ``P`` tokens with
``C = max(1, int(P k cf / E))`` rows an expert, the (token, rank) pairs
in the order ``t k + j``, an expert's pairs past ``C`` dropped; every
position after the prompt (a decode step) is dropless.

Weights are drawn again from the seed (``portbench.weights``), one layer
at a time, as the served bf16 values handed on in f32. TF32 is off.

``prec`` names the precision it is computed in:

* ``"f32"``: the reference, nothing rounded;
* ``"served"``: every tensor that the served model holds in its dtype
  (the embedding rows, the residual stream after each add, the norms'
  outputs, q, k and v after RoPE, the attention output, each matmul's
  output, the SwiGLU product, the logits) rounded to that dtype, the
  products summed and the softmaxes and norms taken in f32: plain
  bfloat16 rounding, a witness of what a sound program reads;
* ``"fp8"``: the control, as ``"served"`` with every linear layer's
  operands (the projections, the router, the experts, the head) in
  float8 e4m3 with an absmax scale per row of the activations and per
  column of the weights, summed in f32: the GEMMs as an H100's fp8
  tensor cores would run them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import weights as W

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Prec:
    held: Optional[torch.dtype]     # the dtype held tensors round to
    fp8: bool                       # linear layers' operands in e4m3


def precision(name: str, served: torch.dtype) -> Prec:
    return {"f32": Prec(None, False), "served": Prec(served, False),
            "fp8": Prec(served, True)}[name]


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


def _low(x: torch.Tensor, p: Prec) -> torch.Tensor:
    """``x`` as the served model holds it: rounded to ``p.held``."""
    return x if p.held is None else x.to(p.held).to(F32)


def _mm(x: torch.Tensor, w: torch.Tensor, p: Prec) -> torch.Tensor:
    if p.fp8:
        return _low(_fp8(x, -1) @ _fp8(w, -2), p)
    return _low(x @ w, p)


def _rms(x: torch.Tensor, scale: torch.Tensor, p: Prec) -> torch.Tensor:
    return _low(x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6)
                * scale, p)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    S, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=F32,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * inv
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attention(spec: dict, w: dict, x: torch.Tensor, p: Prec):
    """One sequence's causal attention block, ``x`` ``[S, d]``."""
    S, d = x.shape
    nh, nkv = spec["num_attention_heads"], spec["num_key_value_heads"]
    hd = spec.get("head_dim") or d // nh
    q = _mm(x, w["attn", "wq"], p).view(S, nh, hd)
    k = _mm(x, w["attn", "wk"], p).view(S, nkv, hd)
    v = _mm(x, w["attn", "wv"], p).view(S, nkv, hd)
    q = _low(_rope(q, spec["rope_theta"]), p)
    k = _low(_rope(k, spec["rope_theta"]), p)
    rep = nh // nkv
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    out = torch.empty(S, nh, hd, dtype=F32, device=x.device)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    for h in range(nh):             # one head at a time: [S, S] scores
        sc = (q[:, h] @ k[:, h].T) / hd ** 0.5
        sc = sc.masked_fill(~mask, float("-inf"))
        out[:, h] = torch.softmax(sc, dim=-1) @ v[:, h]
    return _mm(_low(out.reshape(S, nh * hd), p), w["attn", "wo"], p)


def _swiglu(x, g, u, dn, p):
    h = torch.nn.functional.silu(_mm(x, g, p)) * _mm(x, u, p)
    return _mm(_low(h, p), dn, p)


def _moe(spec: dict, w: dict, x: torch.Tensor, segs: list, p: Prec):
    """The MoE block over every sequence's positions at once, ``x``
    ``[N, d]``; ``segs``: each sequence's ``(start, P)``, its prompt
    being rows ``start .. start + P``."""
    N = x.shape[0]
    E, k = spec["n_routed_experts"], spec["num_experts_per_tok"]
    probs = torch.softmax(_mm(x, w["moe", "router"], p), dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    keep = torch.ones(N, k, dtype=torch.bool, device=x.device)
    for a, P in segs:
        if spec["moe_dispatch"] == "capacity" and P > 1:
            # the prompt's pairs in flat order t k + j; an expert keeps
            # its first C (a one-token prompt prefills dropless, as
            # decode does)
            C = max(1, int(P * k * spec["moe_capacity_factor"] / E))
            flat = idx[a:a + P].reshape(-1)
            hit = torch.nn.functional.one_hot(flat, E)
            rank = (hit.cumsum(0) - hit).gather(1, flat[:, None])[:, 0]
            keep[a:a + P] = (rank < C).view(P, k)
    y = torch.zeros_like(x)
    for e in range(E):
        t, j = torch.nonzero((idx == e) & keep, as_tuple=True)
        if t.numel():
            ye = _swiglu(x[t], w["moe", "w_gate"][e], w["moe", "w_up"][e],
                         w["moe", "w_down"][e], p)
            y.index_add_(0, t, ye * gate[t, j][:, None])
    if spec["n_shared_experts"]:
        y = y + _swiglu(x, w["moe", "shared", "gate"],
                        w["moe", "shared", "up"], w["moe", "shared", "down"],
                        p)
    return _low(y, p)


def logits(spec: dict, leaves, seed: int, seqs, device,
           prec: str = "f32") -> list:
    """``seqs``: ``(tokens, P)`` pairs, the prompt of ``P`` tokens and the
    served tokens after it but the last. Returns, per sequence, the f32
    logits ``[len - P + 1, V]`` of positions ``P - 1 ...``: those that
    chose each served token."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    served = getattr(torch, spec["torch_dtype"])
    p = precision(prec, served)
    lens = [len(t) for t, _ in seqs]
    starts = [sum(lens[:i]) for i in range(len(seqs))]
    segs = [(a, P) for a, (_, P) in zip(starts, seqs)]
    try:
        with torch.no_grad():
            top = W.unstacked(leaves, seed, F32, device, served)
            h = _low(top["embed", "tok"][torch.as_tensor(
                np.concatenate([t for t, _ in seqs]), device=device)], p)
            for layer in range(spec["num_hidden_layers"]):
                w = {q[1:]: t for q, t in W.layer(
                    leaves, seed, layer, F32, device, served).items()}
                x = _rms(h, w["ln1", "scale"], p)
                h = _low(h + torch.cat([
                    _attention(spec, w, x[a:a + n], p)
                    for a, n in zip(starts, lens)]), p)
                h = _low(h + _moe(spec, w, _rms(h, w["ln2", "scale"], p),
                                  segs, p), p)
                del w, x
            return [_mm(_rms(h[a + P - 1:a + n], top["final_norm", "scale"],
                             p), top["embed", "head"], p)
                    for a, n, (_, P) in zip(starts, lens, seqs)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """At each position, the gap by which the chosen token's reference
    logit lies below the reference's best (0 where it is the best)."""
    return ref.max(-1).values - ref.gather(1, chosen[:, None])[:, 0]
