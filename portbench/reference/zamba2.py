"""Plain PyTorch forward of the ``zamba2`` family, in float32, layer by layer.

Zamba2 as ``transformers``' ``modeling_zamba2`` writes it (its plain
paths: eager attention, ``Zamba2MambaMixer.torch_forward``), for the
configuration file's keys. ``x0`` the token embedding, ``h = x0``; for
each of the ``num_hidden_layers`` Mamba2 layers ``i``:

* if ``i`` is the ``j``-th of ``hybrid_layer_ids``, shared block ``j %
  num_mem_blocks`` runs on ``u = RMSNorm([h, x0])`` (2 d wide): causal
  attention with q, k, v of ``attention_head_dim`` per head (RoPE over
  the whole head, theta from the file, halves rotated; softmax scale
  ``(head_dim / 2) ** -0.5``), then RMSNorm, then the GeGLU MLP (exact
  GELU) whose ``gate_up`` gets application ``j``'s adapter ``lora_a @
  lora_b``, then application ``j``'s ``linear``: ``t``; the layer's input
  is ``h + t``, else ``h``;
* ``h = h + Mamba2(RMSNorm(input))``: z, x, B/C (``mamba_ngroups``
  groups, head ``k`` reading group ``k // (nh / g)``) and dt from the
  input; x and B/C through the causal depthwise conv with bias and silu;
  ``dt = softplus(dt + dt_bias)`` floored at ``time_step_min`` (the plain
  path's floor; the file's ``departures`` say so); the SSD ``S_t =
  exp(A dt_t) S_{t-1} + dt_t x_t B_t^T``, ``y_t = S_t C_t + D x_t`` with
  ``A = -exp(A_log)``, in chunks of ``chunk_size`` (within a chunk the
  quadratic form, the state carried between chunks), from a zero state;
  then ``y * silu(z)`` normalised per group of ``d_in / g`` channels (eps
  1e-5) and ``out_proj``;

then a final RMSNorm and the head tied to the embedding (every RMSNorm's
eps ``rms_norm_eps``). Each sequence runs on its own (the recurrence
carries no pads); the matmuls take all sequences' rows at once.

Weights are drawn again from the seed (``portbench.weights``), the
Mamba2 layers one at a time, as the served values handed on in f32. TF32
is off.

``prec`` names the precision it is computed in:

* ``"f32"``: the reference, nothing rounded;
* ``"served"``: every tensor that the served model holds in its dtype
  (the embedding rows, the residual stream after each add, the norms'
  outputs, each matmul's output, the conv's output, q and k after RoPE,
  the attention output, the GeGLU product, the SSD's output, the logits)
  rounded to that dtype, the products summed and the softmaxes, norms,
  step sizes and the SSD state taken in f32: plain bfloat16 rounding, a
  witness of what a sound program reads;
* ``"fp8"``: the control, as ``"served"`` with every linear layer's
  operands (the projections, the adapters, the head) in float8 e4m3 with
  an absmax scale per row of the activations and per column of the
  weights, summed in f32: the GEMMs as an H100's fp8 tensor cores would
  run them.
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


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float,
         p: Prec) -> torch.Tensor:
    return _low(x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
                * scale, p)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    S, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=F32,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * inv
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attention(spec: dict, w: dict, u: torch.Tensor, p: Prec):
    """One sequence's causal attention, ``u`` ``[S, 2 d]`` -> ``[S, d]``."""
    S = u.shape[0]
    nh, nkv = spec["num_attention_heads"], spec["num_key_value_heads"]
    hd = spec["attention_head_dim"]
    scale = (hd / 2) ** -0.5
    q = _mm(u, w["attn", "wq"], p).view(S, nh, hd)
    k = _mm(u, w["attn", "wk"], p).view(S, nkv, hd)
    v = _mm(u, w["attn", "wv"], p).view(S, nkv, hd)
    q = _low(_rope(q, spec["rope_theta"]), p)
    k = _low(_rope(k, spec["rope_theta"]), p)
    rep = nh // nkv
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    out = torch.empty(S, nh, hd, dtype=F32, device=u.device)
    mask = torch.ones(S, S, dtype=torch.bool, device=u.device).tril()
    for h in range(nh):             # one head at a time: [S, S] scores
        sc = (q[:, h] @ k[:, h].T) * scale
        sc = sc.masked_fill(~mask, float("-inf"))
        out[:, h] = torch.softmax(sc, dim=-1) @ v[:, h]
    return _mm(_low(out.reshape(S, nh * hd), p), w["attn", "wo"], p)


def _shared(spec: dict, blk: dict, app: dict, h, x0, lens, p: Prec):
    """The shared block's output ``t`` over every sequence's rows."""
    eps = spec["rms_norm_eps"]
    u = _rms(torch.cat([h, x0], dim=-1), blk["ln1", "scale"], eps, p)
    a = torch.cat([_attention(spec, blk, u[s:s + n], p)
                   for s, n in lens])
    a = _rms(a, blk["ln2", "scale"], eps, p)
    gu = _mm(a, blk["mlp", "gate_up"], p) + _mm(
        _mm(a, app["lora_a"], p), app["lora_b"], p)
    g, up = gu.chunk(2, dim=-1)
    m = _low(torch.nn.functional.gelu(g) * up, p)
    return _mm(_mm(m, blk["mlp", "down"], p), app["linear"], p)


def _conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          p: Prec) -> torch.Tensor:
    """Causal depthwise conv of one sequence ``[S, C]`` (``w`` ``[K, C]``,
    the last tap on the current row), bias, silu."""
    K, S = w.shape[0], u.shape[0]
    pad = torch.nn.functional.pad(u, (0, 0, K - 1, 0))
    out = sum(pad[i:i + S] * w[i] for i in range(K)) + b
    return _low(torch.nn.functional.silu(out), p)


def _ssd(x, dt, A, Bm, Cm, chunk: int) -> torch.Tensor:
    """One sequence's SSD from a zero state, in f32: x ``[S, nh, hd]``,
    dt ``[S, nh]``, A ``[nh]``, Bm, Cm ``[S, nh, ds]`` -> y ``[S, nh,
    hd]``. Within a chunk ``y_i = sum_{j <= i} (C_i . B_j) exp(cum_i -
    cum_j) dt_j x_j + exp(cum_i) S C_i``; the state carried between
    chunks."""
    S, nh, hd = x.shape
    s = torch.zeros(nh, hd, Bm.shape[-1], dtype=F32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        xq, dq = x[c0:c0 + chunk], dt[c0:c0 + chunk]
        Bq, Cq = Bm[c0:c0 + chunk], Cm[c0:c0 + chunk]
        Q = xq.shape[0]
        cum = torch.cumsum(dq * A, dim=0).T                   # [nh, Q]
        causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        diff = torch.where(causal, cum[:, :, None] - cum[:, None, :],
                           torch.full((), -torch.inf, device=x.device))
        sc = torch.einsum("ihs,jhs->hij", Cq, Bq) * torch.exp(diff) \
            * dq.T[:, None, :]
        y = torch.einsum("hij,jhp->ihp", sc, xq) + torch.exp(cum).T[
            :, :, None] * torch.einsum("ihs,hps->ihp", Cq, s)
        w = dq * torch.exp(cum[:, -1:] - cum).T                # [Q, nh]
        s = torch.exp(cum[:, -1])[:, None, None] * s + torch.einsum(
            "jh,jhp,jhs->hps", w, xq, Bq)
        ys.append(y)
    return torch.cat(ys)


def _mamba(spec: dict, w: dict, x: torch.Tensor, lens, p: Prec):
    """A Mamba2 layer over every sequence's (normed) rows ``x``."""
    d_in = spec["mamba_expand"] * spec["hidden_size"]
    nh, hd = spec["n_mamba_heads"], spec["mamba_headdim"]
    g, ds = spec["mamba_ngroups"], spec["mamba_d_state"]
    z = _mm(x, w["mamba", "z_proj"], p)
    xi = _mm(x, w["mamba", "x_proj"], p)
    bc = _mm(x, w["mamba", "bc_proj"], p)
    dt = _mm(x, w["mamba", "dt_proj"], p)
    dt = torch.nn.functional.softplus(dt + w["mamba", "dt_bias"]).clamp(
        min=spec["time_step_min"])
    A = -torch.exp(w["mamba", "A_log"])
    ys = []
    for s, n in lens:
        xs = _conv(xi[s:s + n], w["mamba", "conv_x"],
                   w["mamba", "conv_b_x"], p).view(n, nh, hd)
        bcs = _conv(bc[s:s + n], w["mamba", "conv_bc"],
                    w["mamba", "conv_b_bc"], p)
        Bm, Cm = (t.view(n, g, 1, ds).expand(n, g, nh // g, ds)
                  .reshape(n, nh, ds) for t in bcs.split(g * ds, dim=-1))
        y = _low(_ssd(xs, dt[s:s + n], A, Bm, Cm, spec["chunk_size"]), p)
        ys.append(_low(y + w["mamba", "D"][:, None] * xs, p))
    y = torch.cat(ys).reshape(-1, d_in)
    y = (y * torch.nn.functional.silu(z)).view(-1, g, d_in // g)
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + 1e-5)
    y = _low(y.reshape(-1, d_in) * w["mamba", "norm"], p)
    return _mm(y, w["mamba", "out_proj"], p)


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
    ns = [len(t) for t, _ in seqs]
    lens = [(sum(ns[:i]), n) for i, n in enumerate(ns)]
    apps = {i: j for j, i in enumerate(spec["hybrid_layer_ids"])}
    M, eps = spec["num_mem_blocks"], spec["rms_norm_eps"]
    try:
        with torch.no_grad():
            top = W.unstacked(leaves, seed, F32, device, served)
            emb = top["embed", "tok"]
            x0 = _low(emb[torch.as_tensor(
                np.concatenate([t for t, _ in seqs]), device=device)], p)
            h = x0
            for layer in range(spec["num_hidden_layers"]):
                inp = h
                if layer in apps:
                    j = apps[layer]
                    blk = {q[1:]: t[j % M] for q, t in top.items()
                           if q[0] == "shared"}
                    app = {q[1]: t[j] for q, t in top.items()
                           if q[0] == "apps"}
                    inp = _low(h + _shared(spec, blk, app, h, x0, lens, p),
                               p)
                w = {q[1:]: t for q, t in W.layer(
                    leaves, seed, layer, F32, device, served).items()}
                h = _low(h + _mamba(spec, w, _rms(inp, w["ln1", "scale"],
                                                  eps, p), lens, p), p)
                del w
            return [_mm(_rms(h[s + P - 1:s + n], top["final_norm", "scale"],
                             eps, p), emb.T, p)
                    for (s, n), (_, P) in zip(lens, seqs)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """At each position, the gap by which the chosen token's reference
    logit lies below the reference's best (0 where it is the best)."""
    return ref.max(-1).values - ref.gather(1, chosen[:, None])[:, 0]
