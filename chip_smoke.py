#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. the build: every CUDA source in src/repro_torch/csrc, one nvcc each,
   all started together;
3. kernels: each Hopper kernel against its plain PyTorch version on the
   card at the serving paths' shapes (bf16 and f32, ragged S, T = 1,
   8 slots at ragged positions, over the dense slot cache and over a
   shuffled block pool; the two scans at rwkv6-1.6b's and zamba2-7b's
   prefill shapes; flash and slot decode at zamba2's head_dim 112 and the
   FFN at its d 3584 / d_ff 14336, and each at qwen3-8b's G 4 and
   d 4096 / d_ff 12288; flash on a padded admission group of
   8 x 113 and the FFN at T = 8, the continuous engine's 8 decode slots,
   and at the largest T the drains' batched admission prefills, group
   size x padded length, printed; starcoder2-3b's flash at S 4200 with
   its window of 4096 and G 12 and its slot decode over a ring of 4096,
   full and wrapping past slot 0; stablelm-3b's head width 80 at G 1 in
   flash and slot decode; the FFN at T = 1 at olmo-1b's and stablelm-3b's
   widths; both scans at B = 4, S = 64, a continuous admission group),
   with the maximum error beside its
   tolerance (for bf16 decode, per slot, in ulps of the slot's outputs;
   for the scans also the final state's, and their plans: channel slices
   a head, CTAs, chunks), the kernel's median time (CUDA
   events around one call, L2 flushed before it, the host's enqueue
   hidden behind a spin kernel), the plain version's time, the time of
   the PyTorch library calls that compute the same function where there
   are such (for paged attention: the dense gather plus SDPA, two calls;
   none for the scans; for the FFN the bf16 chain silu(x Wg) * (x Wu) Wd,
   five calls, a yardstick the summary keeps out of library_ms), and the
   bound (the larger of bytes at 3.35 TB/s and FLOPs at the card's peak
   for the dtype), after the timer's floor (a one-element kernel timed
   the same way). The decode rows also give the split plan (n_split,
   tile, merge route), the flash and FFN rows their plans (route, row
   tiles, regime, splits, grid), and cover batch 1 at 17-2000 valid
   slots, masks that stress the split merge (every valid slot in one
   split's tiles, a ring window, a dominant score in the last split),
   and a paged table with sentinel holes and a retired slot, which must
   read 0;
4. model: full-width qwen3-0.6b in f32 (random weights from seed 0), one
   prompt, prefill plus 8 greedy decode steps, kernels against the
   reference path (force_ref): logits within 1e-3, greedy tokens equal;
5. paged model: the same f32 model; two ragged prompts admitted by a
   paged ContinuousBatchingEngine (batched prefill, insert into the block
   pool), then 8 paged decode steps with the kernels against force_ref;
6. serve: full-width qwen3-0.6b in bf16 through LLMServer (virtual clock,
   real tokens) with DecodeEngine(cache_capacity=2048, chunk=16) on
   paper_problem(lam=0.1, alpha=30) and an 8-query stream (seed 0): the
   decode chunks replay the engine's captured CUDA graph of the decode
   step. Exact budget enforcement, the report, prefill/decode wall
   seconds, tokens/s, peak device memory, the graph's captures (1),
   replays, host reads per chunk (1), and each kernel's launch count on
   this run through the replay accounting (a kernel launched 0 times
   fails; slot decode must count one launch per layer per replayed step);
   then the eager-vs-graph pin (the first two requests, budgets capped at
   PIN_BUDGET, through the eager per-token loop and the graph: greedy
   tokens equal, tokens/s of each) and a profiled stretch of decode steps,
   eager and replayed: host wall time per step against the device time of
   its kernels; then the same serve on an int8 KV cache (exact budgets,
   one capture, slot decode once a layer a replayed step, graph tokens
   equal to the eager loop's), with the cache's bytes against the bf16
   cache's and the dequantise's device time a step;
7. continuous serve: the same stream through LLMServer(batch_size=8) with
   ContinuousBatchingEngine(paged=True, max_slots=8, capacity=2048,
   block_size=16, chunk=16), whose chunks replay its captured step: exact
   budgets, the report with its KV occupancy, the graph's counts, launch
   counts (paged decode once per layer per replayed step). This and the
   next two phases run qwen3-0.6b at full width but 8 of its 28 layers
   (QWEN3_BATCHED_LAYERS), to keep the script well inside its time limit;
8. rolling drain: all 8 requests offered to the paged engine at once
   against a 64-block pool (1024 tokens, below the 1590 they need), so
   admission is back-pressured; block invariants and the free list
   checked after the drain; the same drain in slot mode (one admission),
   and again in slot mode offered the paged drain's admission groups at
   its chunks. Each drain captures its step once and must launch its
   decode kernel (paged or slot), once per layer per replayed step, and
   not the other. How many requests' bf16 tokens agree between the
   paged drain and each slot drain is reported, not asserted: a greedy
   argmax on random weights can flip on a summation order (other groups
   prefill at other padded shapes); phase 5 is the check. Then one
   profiled chunk of decode at 8 live slots in paged and slot mode,
   replayed and eager. The int8 drain: the paged drain and the slot drain
   on its groups again on an int8 cache, both launching slot decode and
   never paged decode, tokens equal (asserted: both attend over the same
   dequantised values through the same kernel). The hooks serve:
   LLMServer(batch_size=8) over the paged engine (64 blocks) with the
   admission ladder, PoolPressure, StragglerDecode, a Tracer and a
   MetricsRegistry, on 48 queries at 2x the deployed budgets' service
   rate: every completed request's span tree validated, requests shed
   (zero tokens), exact budgets within their caps and some degraded, the
   pool's audit and a balanced allocator, one capture across the
   ladder's budgets; the metrics' wait and system-time percentiles, the
   degradation occupancy and the engine's wall spans printed; the same
   run without tracer and metrics and without any hook, for their cost;
9. step latency points: a paged engine of b slots, all live, for b = 1,
   2, 4, 8: the replayed step's host time (for fit_step_latency);
10. rwkv6 model and serve: full-width rwkv6-1.6b, phase 4 in f32
   (prefill through the wkv scan kernel) plus every scan of the
   reference prefill held in situ against the kernel and the plain
   versions' floor; its end-to-end logits are held to 1.5 times that
   floor (RWKV_LOGIT_REASON), and an f64 witness measures each f32
   evaluation's prefill logits, and the chunked scan's in f64, against
   the sequential reference in f64. Then phase 6 in bf16 (the scan
   kernel must run);
11. zamba2 model and serve: full-width zamba2-7b (81 Mamba2 layers, the
   shared attention block applied 13 times), phase 4 in f32 with the
   same in-situ check, then phase 6 in bf16 (the SSD scan, flash, slot
   decode and FFN kernels must run; slot decode once per shared-block
   application per replayed step). Each model is freed before the next
   phase. Both then run through the continuous engine:
   *continuous serve*, the stream through LLMServer(batch_size=8) on the
   slot ContinuousBatchingEngine (8 slots, capacity 2048, chunk 16) in
   bf16 at full width, rows admitted in groups of equal prompt length
   (checked): exact budgets, one capture, one host read a chunk, the
   scan once a layer a group, the hybrid's flash once a shared-block
   application a group and slot decode once an application a replayed
   step; *recurrent drain*, 8 of the stream's prompts cut to two lengths
   (4 of each) so each group's scans run at B = 4 (checked), in f32 at
   a cut depth (rwkv6 4 of 24 layers; zamba2 one group of 6 plus its 3
   remaining layers), the step run eagerly: each row's first 8 decode
   logits within 1e-3 of the same prompt served alone through
   DecodeEngine, and its tokens equal;
12. the other dense ids, olmo-1b (LayerNorm without parameters),
   stablelm-3b (LayerNorm, head width 80) and starcoder2-3b (LayerNorm,
   GELU MLP, G 12, a sliding window of 4096): phase 4 in f32 at full
   width (flash and slot decode launched; the FFN kernel exactly for the
   SwiGLU models), for starcoder2 the *window check* (a 4200-token prompt
   into a ring of 4096 and 64 decode steps past the wrap, kernels against
   force_ref: logits within 1e-3, tokens equal), phase 6 in bf16 (the FFN
   launched on olmo and stablelm, never on starcoder2), and starcoder2's
   continuous serve as in phase 11 (flash once a layer a group, slot
   decode once a layer a replayed step);
13. qwen3-8b, the paper's model: phases 4 and 5 in f32 at full width and
   4 of its 36 layers (QWEN3_8B_F32_LAYERS: the f32 weights and the
   reference path's copies), then phase 6 in bf16 at full width and full
   depth, the server on the wall clock (ServerConfig(mode="wall"));
14. calibration: fit_latency to the qwen3-8b serve's per-request (tokens,
   seconds), fit_step_latency to phase 9's points; paper_problem solved
   again with the fitted t0 and c, its budgets printed beside the
   paper's, and the occupancy model at the fitted constants. These print
   numbers and gate nothing on speed.

The line before the last is the kernels' JSON summary (with each kernel's
launches on every serve path that ran it, the int8 serve, the int8 paged
drain, the hooks serve, every continuous serve, the recurrent drains and
the window check among them); the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                        # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,            # dense tensor-core bf16
              torch.float32: 67e12}              # f32 outside tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
TOL_REASON = {
    torch.bfloat16: "the repo's bf16 kernel tolerance; kernel and plain "
                    "round at the same points and differ only in f32 "
                    "summation order, i.e. about one bf16 ulp of the output",
    torch.float32: "the repo's f32 kernel tolerance; only the f32 "
                   "summation order differs",
}
DECODE_BF16_ULPS = 2
DECODE_BF16_REASON = (
    "bf16 decode, per slot: 2 bf16 ulps of the slot's largest |out| (at "
    "most 2e-2); kernel and plain round p and out at the same points and "
    "differ in f32 summation order and in the running max p is rounded "
    "against, which moves out by under one ulp plus its final rounding")
# ragged per-slot positions of the 8-slot decode cases (paged and slot)
POS = (17, 45, 100, 300, 600, 1100, 1500, 2000)
FFN_F32_TOL = 1e-4
FFN_F32_REASON = ("f32 sums over d = 1024 and d_ff = 3072 terms taken in "
                  "another order than torch.matmul's")
LOGIT_TOL = 1e-3
LOGIT_REASON = ("f32 end to end; kernels and reference sum in other orders "
                "(the scans' reference is the sequential recurrence) and the "
                "difference compounds over the layers; 1e-3 is about 0.1% "
                "of the logits' scale")
RWKV_FLOOR_FACTOR = 1.5
RWKV_LOGIT_REASON = (
    "1.5 x plain_path_logits_max_abs_err, the floor measured in this run "
    "with each scan's plain version in place of its kernel: two exact f32 "
    "evaluations of full-width rwkv6 with random weights (the sequential "
    "reference and the chunked plain version) already differ far above "
    "1e-3 after 24 layers. f64_witness holds every f32 evaluation's "
    "prefill logits against the sequential reference in f64 (the kernel "
    "path may sit at most 1.5 x as far from it as the f32 reference or "
    "plain path does) and the chunked scan in f64 against it within 1e-3; "
    "every scan is also held in situ at the scan tolerances, and greedy "
    "tokens must agree")
SCAN_REASON = {
    torch.bfloat16: "tests/test_kernels.py's bf16 scan tolerance: rtol 5e-2, "
                    "atol 5e-2 * max|y|",
    torch.float32: "tests/test_kernels.py's f32 scan tolerances: rwkv6 "
                   "rtol = atol = 1e-4; SSD rtol 1e-3, atol 2e-5 * max|y|; "
                   "f32 sums over a chained state in another order",
}
STATE_TOL = 1e-3          # the final f32 state, rtol = atol (test_kernels)
# the serving paths' shapes at qwen3-0.6b's widths
H, G, HD, D, DFF = 8, 2, 128, 1024, 3072
# rwkv6-1.6b's and zamba2-7b's: wkv heads, SSD heads, state, shared block
RWKV_H, RWKV_HD = 32, 64
SSD_H, SSD_HD, SSD_DS = 112, 64, 64
Z_H, Z_HD, Z_D, Z_DFF = 32, 112, 3584, 14336
SCAN_S = (18, 113, 128)   # the stream's shortest and longest prompt, 128
QWEN3_BATCHED_LAYERS = 8  # depth of the continuous serve and the drains
# qwen3-8b's: 8 kv heads of 128 with 4 query heads each, d 4096 / d_ff 12288
Q8_H, Q8_G, Q8_D, Q8_DFF = 8, 4, 4096, 12288
QWEN3_8B_F32_LAYERS = 4   # depth of qwen3-8b's f32 check (f32 weights + ref)
# starcoder2-3b's: 2 kv heads of 128 with 12 query heads each, a window of
# 4096 (its decode ring), and the window check's prompt, past the window
SC_H, SC_G, SC_WINDOW, SC_S = 2, 12, 4096, 4200
SC_STEPS = 64             # the window check's decode steps, all past the wrap
# stablelm-3b's: 32 kv heads of 80, one query head each; d / d_ff
SL_H, SL_HD, SL_D, SL_DFF = 32, 80, 2560, 6912
OLMO_D, OLMO_DFF = 2048, 8192  # olmo-1b's d / d_ff
SCAN_GROUP_B, SCAN_GROUP_S = 4, 64  # a continuous admission group's scans
DRAIN_BUDGET = 12         # the recurrent drain's budget (no answer tokens)
PIN_BUDGET = 64           # budget cap of the eager-vs-graph pin's requests
OCCUPANCIES = (1, 2, 4, 8)  # continuous engines timed for fit_step_latency
HOOKS_QUERIES = 48        # the hooks serve's stream, at 2x the service rate



class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, flush: torch.Tensor, reps: int = 25) -> float:
    """Median of per-call CUDA-event times, L2 flushed before each call.

    A spin kernel queued ahead of the start event keeps the card busy while
    the host enqueues ``fn``, so the interval holds device time only, not
    the host's launch gaps (which would otherwise inflate functions made of
    many small PyTorch ops)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)             # ~1 ms of spinning
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def compare(got, want, atol, rtol) -> tuple:
    diff = (got.float() - want.float()).abs()
    ok = bool(torch.all(diff <= atol + rtol * want.float().abs()))
    return float(diff.max()), ok


def slot_bf16_ulp(want: torch.Tensor) -> torch.Tensor:
    """[B]: one bf16 ulp (2^(e - 7) for a value in [2^e, 2^(e+1))) of the
    largest |out| of each slot of a decode output [B, ...]."""
    m = want.float().abs().flatten(1).amax(1).clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def decode_bf16_tol(want: torch.Tensor) -> torch.Tensor:
    """Per-slot absolute tolerance [B] of a bf16 decode output:
    DECODE_BF16_ULPS ulps of the slot's largest |out|, at most 2e-2."""
    return (DECODE_BF16_ULPS * slot_bf16_ulp(want)).clamp_max(
        TOL[torch.bfloat16])


def scan_tol(name: str, dtype, want: torch.Tensor) -> tuple:
    """(atol, rtol) of a scan's output, tests/test_kernels.py's."""
    scale = float(want.float().abs().max())
    if dtype == torch.bfloat16:
        return 5e-2 * scale, 5e-2
    if name == "rwkv6_scan":
        return 1e-4, 1e-4
    return 2e-5 * scale, 1e-3


def kernel_cases(dev, flush):
    """Every kernel against its plain version at the serving paths' shapes.
    Returns (rows, {kernel: row of the JSON summary})."""
    import torch.nn.functional as F

    from repro_torch.core import paper_problem
    from repro_torch.kernels import (_cuda, decode_attention,
                                     flash_attention, fused_ffn, rwkv6_scan,
                                     ssd_scan)
    from repro_torch.queueing_sim import generate_stream

    # the serve phases' stream: its prompt lengths set the prefill shapes
    prompt_lens = [q.prompt_len for q in generate_stream(
        paper_problem(lam=0.1, alpha=30.0).tasks, 0.1, 8, seed=0).queries]

    gen = torch.Generator(device=dev).manual_seed(0)
    rows, summary = [], {}
    # the timer's floor: one one-element kernel, timed as the rows below
    tiny = torch.zeros(1, device=dev)
    print(json.dumps({"phase": "timer_floor", "case": "x.add_(1), 1 element",
                      "ms": median_ms(lambda: tiny.add_(1), flush)}))

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def record(name, case, dtype, got, want, tol, reason, fn, plain, lib,
               nbytes, flops, main, library="one call", state=None,
               fields=None, one_call=True):
        """``tol``: one float (atol = rtol), a per-slot tensor of atols, or
        an (atol, rtol) pair. ``state``: the scans' (got, want) final
        states, held at STATE_TOL. ``fields``: added to the row (the
        kernels' plans). ``one_call``: ``lib`` is one PyTorch call, the
        summary's ``library_ms``; otherwise a yardstick timed beside the
        kernel (``library_one_call`` false) that the summary leaves out."""
        per_slot, extra = {}, {}
        if isinstance(tol, torch.Tensor):            # one tolerance per slot
            err, ok = compare(got, want,
                              tol.view((-1,) + (1,) * (want.dim() - 1)), 0.0)
            slot_err = (got.float() - want.float()).abs().flatten(1).amax(1)
            per_slot = {
                "slot_max_abs_out": want.float().abs().flatten(1).amax(1)
                .tolist(),
                "slot_err_ulps": (slot_err / slot_bf16_ulp(want)).tolist()}
            tol = tol.tolist()
        elif isinstance(tol, tuple):
            err, ok = compare(got, want, *tol)
            tol = {"atol": tol[0], "rtol": tol[1]}
        else:
            err, ok = compare(got, want, tol, tol)
        if state is not None:
            s_err, s_ok = compare(*state, STATE_TOL, STATE_TOL)
            extra = {"state_max_abs_err": s_err, "state_tol": STATE_TOL}
            ok = ok and s_ok
        bms, by = bound(nbytes, flops, dtype)
        row = {"name": name, "case": case, "dtype": str(dtype)[6:],
               "max_abs_err": err, "tol": tol, "tol_reason": reason,
               **per_slot, **extra, "ok": ok, "ms": median_ms(fn, flush),
               "plain_ms": median_ms(plain, flush),
               "library_ms": None if lib is None else median_ms(lib, flush),
               "library": None if lib is None else library,
               "library_one_call": lib is not None and one_call,
               "bound_ms": bms, "bound_by": by, **(fields or {})}
        if lib is not None:
            row["beats_library" if one_call else "beats_chain"] = (
                row["ms"] < row["library_ms"])
        print(json.dumps(row))
        rows.append(row)
        check(ok, f"{name} {case} {row['dtype']}: max err {err} > tol {tol}"
                  f"{' (or the state)' if state is not None else ''}")
        if main:
            summary[name] = row

    # -- 1. prefill flash attention: q [B,S,nh,hd], k/v [B,S,nkv,hd] views
    def flash_fields(B, S, H, G, HD, dtype):
        plan = flash_attention.flash_plan(B, H, G, S, HD, dtype,
                                          _cuda.sm_count(0))
        return {"route": plan.route, "row_tiles": plan.row_tiles,
                "rows_per_cta": plan.rows_per_cta, "warps": plan.warps,
                "ctas": plan.ctas, "hd_pad": plan.hd_pad,
                "block_k": plan.block_k}

    def flash_case(dtype, S, H, G, HD, main, B=1, window=None):
        qm = randn(B, S, H * G, HD, dtype=dtype)
        km = randn(B, S, H, HD, dtype=dtype)
        vm = randn(B, S, H, HD, dtype=dtype)
        q = qm.reshape(B, S, H, G, HD).permute(0, 2, 3, 1, 4)
        k, v = km.permute(0, 2, 1, 3), vm.permute(0, 2, 1, 3)
        fa = flash_attention.flash_attention
        plain = flash_attention.flash_attention_plain
        got = fa(q, k, v, window=window)
        want = plain(q, k, v, window=window)
        ql = qm.transpose(1, 2)
        kl = k.repeat_interleave(G, dim=1)
        vl = v.repeat_interleave(G, dim=1)
        pos = torch.arange(S, device=dev)
        mask = pos[None] <= pos[:, None]
        if window is not None:
            mask &= pos[None] > pos[:, None] - window
        el = qm.element_size()
        nbytes = B * (2 * H * G + 2 * H) * S * HD * el
        # the (query, key) pairs the mask keeps: a window cuts each row
        pairs = sum(min(s + 1, window or S) for s in range(S))
        flops = B * H * G * pairs * 4 * HD
        case = f"B={B} S={S} H={H} G={G} hd={HD}"
        if window is not None:
            case += f" window={window}"
        record("flash_attention", case, dtype,
               got, want, TOL[dtype], TOL_REASON[dtype],
               lambda: fa(q, k, v, window=window),
               lambda: plain(q, k, v, window=window),
               lambda: F.scaled_dot_product_attention(ql, kl, vl,
                                                      attn_mask=mask),
               nbytes, flops, main=main,
               fields=flash_fields(B, S, H, G, HD, dtype))

    for dtype, S in ((torch.bfloat16, 16), (torch.bfloat16, 37),
                     (torch.bfloat16, 128), (torch.float32, 37),
                     (torch.float32, 128)):
        flash_case(dtype, S, H, G, HD,
                   main=(dtype == torch.bfloat16 and S == 128))
    # a padded admission group of the rolling drain (8 prompts, padded to
    # the longest, 113)
    flash_case(torch.bfloat16, max(prompt_lens), H, G, HD, main=False,
               B=len(prompt_lens))
    for dtype, S in ((torch.bfloat16, 113), (torch.float32, 37)):
        flash_case(dtype, S, Z_H, 1, Z_HD, main=False)     # zamba2's block
        flash_case(dtype, S, Q8_H, Q8_G, HD, main=False)   # qwen3-8b's
    # starcoder2-3b's prefill past its window (the window check's prompt),
    # and stablelm-3b's head width 80 at G = 1 (padded to 128 in the CTA)
    flash_case(torch.bfloat16, SC_S, SC_H, SC_G, HD, main=False,
               window=SC_WINDOW)
    flash_case(torch.bfloat16, max(prompt_lens), SL_H, 1, SL_HD, main=False)

    # -- 2. slot decode attention over the stacked cache's [B,C,nkv,hd]:
    # batch 1 (DecodeEngine) and the continuous engine's 8 slot rows at
    # ragged positions, each with its own valid row; then masks that
    # stress the split-KV merge
    C = 2048

    def split_fields(B, H, n_pos, HD, dtype, bs=None):
        plan = decode_attention.split_plan(B, H, n_pos, HD, dtype,
                                           _cuda.sm_count(0), block_size=bs)
        return {"n_split": plan.n_split, "tile": plan.tile,
                "merge": ("thread block cluster, through distributed "
                          "shared memory, in split order")
                if plan.n_split > 1
                else "none: one split writes the output"}

    def decode_case(dtype, B, n_valid, H, G, HD, main, mask=None,
                    what=None, dominant=None, C=C):
        """``mask``: a [B, C] valid mask in place of the prefixes
        ``n_valid`` (then ``what`` names it); ``dominant``: a slot whose
        key is set to 4 q of head 0, so its score dominates."""
        q = randn(B, H, G, HD, dtype=dtype)
        kc = randn(B, C, H, HD, dtype=dtype)
        vc = randn(B, C, H, HD, dtype=dtype)
        k, v = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
        if dominant is not None:
            k[:, :, dominant] = q[:, :, 0] * 4
        if mask is None:
            lens = torch.tensor(n_valid, device=dev)[:, None]
            valid = torch.arange(C, device=dev)[None] < lens
            what = f"valid={list(n_valid)}"
        else:
            valid = mask
        da = decode_attention.decode_attention
        got = da(q, k, v, valid)
        want = decode_attention.decode_attention_plain(q, k, v, valid)
        ql = q.reshape(B, H * G, 1, HD)
        kl = k.repeat_interleave(G, dim=1)
        vl = v.repeat_interleave(G, dim=1)
        lmask = valid[:, None, None, :]
        el = q.element_size()
        rows_read = int(valid.sum())
        nbytes = (2 * B * H * G * HD + 2 * rows_read * H * HD) * el + B * C
        flops = 4 * rows_read * H * G * HD
        tol, reason = ((decode_bf16_tol(want), DECODE_BF16_REASON)
                       if dtype == torch.bfloat16
                       else (TOL[dtype], TOL_REASON[dtype]))
        record("decode_attention",
               f"B={B} C={C} {what} H={H} G={G} hd={HD}",
               dtype, got, want, tol, reason,
               lambda: da(q, k, v, valid),
               lambda: decode_attention.decode_attention_plain(q, k, v,
                                                               valid),
               lambda: F.scaled_dot_product_attention(ql, kl, vl,
                                                      attn_mask=lmask),
               nbytes, flops, main=main,
               fields=split_fields(B, H, C, HD, dtype))

    for dtype, B, n_valid in ((torch.bfloat16, 1, (17,)),
                              (torch.bfloat16, 1, (100,)),
                              (torch.bfloat16, 1, (300,)),
                              (torch.bfloat16, 1, (2000,)),
                              (torch.bfloat16, 8, tuple(p + 1 for p in POS)),
                              (torch.float32, 1, (300,)),
                              (torch.float32, 2, (45, 1500))):
        decode_case(dtype, B, n_valid, H, G, HD,
                    main=(dtype == torch.bfloat16 and n_valid == (300,)))
    for dtype in (torch.bfloat16, torch.float32):        # zamba2's block
        decode_case(dtype, 1, (300,), Z_H, 1, Z_HD, main=False)
        decode_case(dtype, 1, (300,), Q8_H, Q8_G, HD, main=False)  # qwen3-8b
        # starcoder2-3b's ring of 4096 at G 12: full (wrapped), and a mask
        # that wraps past slot 0; stablelm-3b's head width 80 at G 1
        ring = torch.ones(1, SC_WINDOW, dtype=torch.bool, device=dev)
        decode_case(dtype, 1, None, SC_H, SC_G, HD, False, mask=ring,
                    what=f"valid=all {SC_WINDOW} (a wrapped ring)",
                    C=SC_WINDOW)
        ring = ring.clone()
        ring[0, 200:SC_WINDOW - 300] = False
        decode_case(dtype, 1, None, SC_H, SC_G, HD, False, mask=ring,
                    what=f"valid={SC_WINDOW - 300}..{SC_WINDOW - 1}, 0..199 "
                         "(a ring wrapping past slot 0)", C=SC_WINDOW)
        decode_case(dtype, 1, (300,), SL_H, 1, SL_HD, main=False)
    # merge-adversarial masks at batch 1 (n_split > 1): every valid slot in
    # split 0's tiles; a ring window; one dominant score in the last split
    for dtype in (torch.bfloat16, torch.float32):
        plan = decode_attention.split_plan(1, H, C, HD, dtype,
                                           _cuda.sm_count(0))
        check(plan.n_split > 1, f"slot decode at B=1 C={C}: one split")
        one = torch.zeros(1, C, dtype=torch.bool, device=dev)
        for t in plan.tiles(0):
            one[0, t * plan.tile:(t + 1) * plan.tile] = True
        ring = torch.zeros(1, C, dtype=torch.bool, device=dev)
        ring[0, 1000:1301] = True
        last = plan.tiles(plan.n_split - 1)[0] * plan.tile + 5
        decode_case(dtype, 1, None, H, G, HD, False, mask=one,
                    what=f"valid=split 0's tiles {list(plan.tiles(0))}")
        decode_case(dtype, 1, None, H, G, HD, False, mask=ring,
                    what="valid=1000..1300 (ring window)")
        decode_case(dtype, 1, None, H, G, HD, False,
                    mask=torch.arange(C, device=dev)[None] < 2000,
                    what=f"valid=[2000] dominant slot {last} (last split)",
                    dominant=last)

    # -- 3. paged decode attention over one layer of the engine's pool:
    # 8 slots of a 2048-token table (bs 16, n_bt 128) over P = 1024 blocks
    # (the engine's default pool at 8 slots), ragged positions, tables
    # drawn from a shuffled pool with sentinels past each slot's last block.
    # The adversarial table adds sentinel holes inside two slots' rows (a
    # 64-position tile straddles them) and a retired slot whose entries
    # are all sentinels at a stale position: it must read 0 and is kept
    # out of the comparison (the plain version averages a clipped block).
    P, bs, n_bt = 1024, 16, 128
    pda = decode_attention.paged_decode_attention
    pda_plain = decode_attention.paged_decode_attention_plain

    def paged_case(dtype, pos_list, main, holes=(), retired=None, G=G):
        B = len(pos_list)
        perm = torch.randperm(P, generator=torch.Generator().manual_seed(0))
        tables = torch.full((B, n_bt), P, dtype=torch.int32)
        used = 0
        for b, p in enumerate(pos_list):
            if b == retired:
                continue
            n = p // bs + 1
            tables[b, :n] = perm[used:used + n]
            used += n
        for b, j in holes:
            tables[b, j] = P
        tables = tables.to(dev)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        slots = torch.arange(n_bt * bs, device=dev)
        vis = ((slots[None] <= pos[:, None])
               & (tables < P).repeat_interleave(bs, dim=1))
        lmask = vis[:, None, None, :]
        gather = tables.long().clamp(max=P - 1)
        q = randn(B, H, G, HD, dtype=dtype)
        # one layer of the engine's [L, P + 1, bs, nkv, hd] pools, as the
        # model passes it: a view without the trash block
        pool = randn(2, P + 1, bs, H, HD, dtype=dtype)
        kp, vp = pool[0, :P], pool[1, :P]
        got = pda(q, kp, vp, tables, pos)
        want = pda_plain(q, kp, vp, tables, pos)
        keep = [b for b in range(B) if b != retired]
        if retired is not None and got.is_cuda:     # the plain version
            check(bool((got[retired] == 0).all()),  # averages a block
                  "paged decode: the all-sentinel slot is not 0")
        got, want = got[keep], want[keep]
        ql = q.reshape(B, H * G, 1, HD)

        def library(q=ql, kp=kp, vp=vp):
            kd = kp[gather].reshape(B, n_bt * bs, H, HD).transpose(1, 2)
            vd = vp[gather].reshape(B, n_bt * bs, H, HD).transpose(1, 2)
            return F.scaled_dot_product_attention(q, kd, vd, attn_mask=lmask,
                                                  enable_gqa=True)
        el = q.element_size()
        rows_read = int(vis.sum())
        nbytes = ((2 * B * H * G * HD + 2 * rows_read * H * HD) * el
                  + tables.numel() * 4 + B * 4)
        flops = 4 * rows_read * H * G * HD
        tol, reason = ((decode_bf16_tol(want), DECODE_BF16_REASON)
                       if dtype == torch.bfloat16
                       else (TOL[dtype], TOL_REASON[dtype]))
        what = f"pos={list(pos_list)}"
        if holes or retired is not None:
            what += f" sentinel holes {list(holes)}, slot {retired} retired"
        record("paged_decode_attention",
               f"B={B} P={P} bs={bs} n_bt={n_bt} {what} H={H} G={G} "
               f"hd={HD}", dtype, got, want, tol, reason,
               lambda: pda(q, kp, vp, tables, pos),
               lambda: pda_plain(q, kp, vp, tables, pos), library,
               nbytes, flops, main=main,
               library="two calls: the k/v gather through the block table "
                       "(index) and scaled_dot_product_attention",
               fields=split_fields(B, H, n_bt * bs, HD, dtype, bs=bs))

    for dtype in (torch.bfloat16, torch.float32):
        paged_case(dtype, POS, main=(dtype == torch.bfloat16))
        paged_case(dtype, POS[:6] + (2000, 1500), main=False,
                   holes=((3, 2), (6, 5), (6, 64)), retired=7)
        paged_case(dtype, POS, main=False, G=Q8_G)          # qwen3-8b's

    # -- 4. fused SwiGLU FFN, E = 1: T = 1 at batch-1 decode, 8 at the
    # continuous engine's 8 slots, S at prefill, and the largest padded
    # admission group of the drains (group size x longest prompt)
    def ffn_fields(T, D, DFF, dtype):
        plan = fused_ffn.ffn_plan(1, T, D, DFF, dtype, _cuda.sm_count(0))
        out = {"route": plan.route, "regime": plan.regime}
        if plan.route == "tensor_core":
            out.update(bm=plan.bm, ks_up=plan.ks_up, ks_down=plan.ks_down,
                       ctas_up=plan.grid_up, ctas_down=plan.grid_down,
                       scratch_bytes=plan.scratch_bytes)
        else:
            out.update(bt=plan.bt, n_split=plan.n_split)
        return out

    def ffn_case(dtype, T, D, DFF, main):
        x = randn(1, T, D, dtype=dtype)
        wg = randn(1, D, DFF, dtype=dtype, scale=D ** -0.5)
        wu = randn(1, D, DFF, dtype=dtype, scale=D ** -0.5)
        wd = randn(1, DFF, D, dtype=dtype, scale=DFF ** -0.5)
        ff = fused_ffn.fused_ffn
        got = ff(x, wg, wu, wd)
        want = fused_ffn.fused_ffn_plain(x, wg, wu, wd)
        tol, reason = ((FFN_F32_TOL, FFN_F32_REASON)
                       if dtype == torch.float32
                       else (TOL[dtype], TOL_REASON[dtype]))
        el = x.element_size()
        nbytes = (2 * T * D + 3 * D * DFF) * el
        flops = 6 * T * D * DFF

        def chain(x=x[0], wg=wg[0], wu=wu[0], wd=wd[0]):
            return (F.silu(x @ wg) * (x @ wu)) @ wd
        record("fused_ffn", f"E=1 T={T} d={D} d_ff={DFF}", dtype, got, want,
               tol, reason, lambda: ff(x, wg, wu, wd),
               lambda: fused_ffn.fused_ffn_plain(x, wg, wu, wd), chain,
               nbytes, flops, main=main, one_call=False,
               library="chain of 5 calls: x @ Wg, x @ Wu (torch.matmul), "
                       "silu, the product, @ Wd",
               fields=ffn_fields(T, D, DFF, dtype))

    drain_T = len(prompt_lens) * max(prompt_lens)
    print(json.dumps({"phase": "drain_admission_T", "prompts": prompt_lens,
                      "largest_group_T": drain_T,
                      "why": "the slot drain admits all 8 requests in one "
                             "prefill, right-padded to the longest"}))
    for dtype, T in ((torch.bfloat16, 1), (torch.bfloat16, 8),
                     (torch.bfloat16, 37), (torch.bfloat16, 128),
                     (torch.bfloat16, drain_T), (torch.float32, 1),
                     (torch.float32, 128)):
        ffn_case(dtype, T, D, DFF, main=(dtype == torch.bfloat16 and T == 1))
    for dtype, T in ((torch.bfloat16, 1), (torch.bfloat16, 8),
                     (torch.bfloat16, 37), (torch.float32, 1)):
        ffn_case(dtype, T, Z_D, Z_DFF, main=False)       # zamba2's block
        ffn_case(dtype, T, Q8_D, Q8_DFF, main=False)     # qwen3-8b's
    for dtype in (torch.bfloat16, torch.float32):        # decode, T = 1
        ffn_case(dtype, 1, OLMO_D, OLMO_DFF, main=False)  # olmo-1b's
        ffn_case(dtype, 1, SL_D, SL_DFF, main=False)      # stablelm-3b's

    # -- 5. the scans at the recurrent prefills' shapes (B = 1), and at a
    # continuous admission group's (B = 4 equal-length prompts), in the
    # models' layouts: [B, S, H, ...] viewed as [B, H, S, ...]
    sms = _cuda.sm_count(0)

    def scan_cases(dtype, B, S, main):
        # rwkv6: decays -exp(1.5 N - 2), from ~0 down to ~-12 per token
        r, k, v = (randn(B, S, RWKV_H, RWKV_HD, dtype=dtype, scale=0.5)
                   .transpose(1, 2) for _ in range(3))
        la = -torch.exp(randn(B, S, RWKV_H, RWKV_HD, dtype=torch.float32,
                              scale=1.5) - 2.0).transpose(1, 2)
        u = randn(RWKV_H, RWKV_HD, dtype=torch.float32,
                  scale=0.3)[None].expand(B, RWKV_H, RWKV_HD)
        got, gs = rwkv6_scan.rwkv6_scan(r, k, v, la, u)
        want, ws = rwkv6_scan.rwkv6_scan_plain(r, k, v, la, u)
        el = r.element_size()
        # r, k, v, y in the dtype; la, the final state in f32; u once
        nbytes = B * RWKV_H * (4 * S * RWKV_HD * el + S * RWKV_HD * 4
                               + RWKV_HD * RWKV_HD * 4) + RWKV_H * RWKV_HD * 4
        # the recurrence: 7 hd^2 per token and head
        flops = 7 * B * RWKV_H * S * RWKV_HD * RWKV_HD
        record("rwkv6_scan", f"B={B} H={RWKV_H} S={S} hd={RWKV_HD}", dtype,
               got, want, scan_tol("rwkv6_scan", dtype, want),
               SCAN_REASON[dtype],
               lambda: rwkv6_scan.rwkv6_scan(r, k, v, la, u),
               lambda: rwkv6_scan.rwkv6_scan_plain(r, k, v, la, u), None,
               nbytes, flops, main=main, state=(gs, ws),
               fields=rwkv6_scan.rwkv6_plan(B, RWKV_H, S, RWKV_HD, dtype,
                                            sms).fields())
        # ssd: dt = softplus(N - 2), A = -1; B/C one row for all heads
        x = randn(B, S, SSD_H, SSD_HD, dtype=dtype).transpose(1, 2)
        dt = F.softplus(randn(B, S, SSD_H, dtype=torch.float32) - 2.0) \
            .transpose(1, 2)
        a = -dt
        bc = randn(B, S, 2 * SSD_DS, dtype=dtype)
        Bm = bc[..., :SSD_DS][:, None].expand(B, SSD_H, S, SSD_DS)
        Cm = bc[..., SSD_DS:][:, None].expand(B, SSD_H, S, SSD_DS)
        got, gs = ssd_scan.ssd_scan(x, dt, a, Bm, Cm)
        want, ws = ssd_scan.ssd_scan_plain(x, dt, a, Bm, Cm)
        el = x.element_size()
        # x, y per head in the dtype, dt and a in f32, B and C once a row
        # (shared by the heads), the final state in f32
        nbytes = B * (SSD_H * (2 * S * SSD_HD * el + 2 * S * 4
                               + SSD_HD * SSD_DS * 4)
                      + 2 * S * SSD_DS * el)
        # the recurrence: 5 hd ds per token and head
        flops = 5 * B * SSD_H * S * SSD_HD * SSD_DS
        record("ssd_scan", f"B={B} H={SSD_H} S={S} hd={SSD_HD} "
               f"ds={SSD_DS}", dtype, got, want,
               scan_tol("ssd_scan", dtype, want), SCAN_REASON[dtype],
               lambda: ssd_scan.ssd_scan(x, dt, a, Bm, Cm),
               lambda: ssd_scan.ssd_scan_plain(x, dt, a, Bm, Cm), None,
               nbytes, flops, main=main, state=(gs, ws),
               fields=ssd_scan.ssd_plan(B, SSD_H, S, SSD_HD, SSD_DS,
                                        dtype, sms).fields())

    for dtype in (torch.bfloat16, torch.float32):
        for S in SCAN_S:
            scan_cases(dtype, 1, S, main=dtype == torch.bfloat16 and S == 113)
        scan_cases(dtype, SCAN_GROUP_B, SCAN_GROUP_S, main=False)
    return rows, summary


def _greedy_run(cfg, params, prompt, force_ref, teacher=None,
                capacity: int = 64, steps: int = 8):
    """Prefill into a cache of ``capacity`` plus ``steps`` decode steps;
    returns (logits per step, greedy tokens). With ``teacher`` (a token
    list) the steps are fed those tokens instead of their own argmax."""
    from repro_torch.models import decode_step, forward

    out = forward(cfg, params, prompt, return_cache=True,
                  cache_capacity=capacity, force_ref=force_ref)
    logits, cache = [out.logits], out.cache
    toks = [out.logits[:, -1:].argmax(-1)]
    for i in range(steps):
        tok = toks[-1] if teacher is None else teacher[i]
        step = decode_step(cfg, params, tok, cache, force_ref=force_ref)
        logits.append(step.logits)
        toks.append(step.logits.argmax(-1))
        cache = step.cache
    return logits, toks


def _max_err(a: list, b: list) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def scan_in_situ(cfg, params, prompt) -> dict:
    """Every scan of the reference path's prefill, held against the kernel
    on the very same activations at the scan tolerances: the kernel's
    error in the model, free of what the model's layers make of it."""
    from repro_torch.kernels import ops
    from repro_torch.models import forward

    name = "rwkv6_scan" if cfg.backbone_kind == "rwkv6" else "ssd_scan"
    orig = getattr(ops, name)
    rows = []

    def both(*args, force_ref=False):
        want = orig(*args, force_ref=True)
        got = orig(*args)
        ey, oky = compare(got[0], want[0], *scan_tol(name, torch.float32,
                                                     want[0]))
        es, oks = compare(got[1], want[1], STATE_TOL, STATE_TOL)
        rows.append((ey, float(want[0].abs().max()), es, oky and oks))
        return want
    setattr(ops, name, both)
    try:
        forward(cfg, params, prompt, force_ref=True)
    finally:
        setattr(ops, name, orig)
    return {"kernel": name, "calls": len(rows),
            "y_max_abs_err": max(r[0] for r in rows),
            "y_max_abs": max(r[1] for r in rows),
            "state_max_abs_err": max(r[2] for r in rows),
            "ok": all(r[3] for r in rows)}


def _double(tree):
    if isinstance(tree, dict):
        return {k: _double(v) for k, v in tree.items()}
    return tree.double()


def f64_witness(cfg, params, prompt, f32_prefill: dict) -> dict:
    """Prefill logits of each f32 evaluation (``f32_prefill``: name ->
    [1, S, V]) against the sequential reference run in f64, and the
    chunked scan (the plain version, the kernel's arithmetic) run in f64
    against the same: whether the f32 evaluations part by rounding or by
    the scan's form. RWKV6 only (its model computes in f64 when fed f64
    weights); the kernel takes no f64, so its f32 path stands for it."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain
    from repro_torch.models import forward

    V = cfg.vocab_size                      # padded columns hold -1e30
    p64 = _double(params)
    exact = forward(cfg, p64, prompt, force_ref=True).logits[..., :V]
    kernel, ops._rwkv = ops._rwkv, rwkv6_scan_plain
    try:
        chunked = forward(cfg, p64, prompt).logits[..., :V]
    finally:
        ops._rwkv = kernel
    del p64
    out = {f"{name}_f32_vs_f64_ref": float((x[..., :V].double() - exact)
                                           .abs().max())
           for name, x in f32_prefill.items()}
    out["chunked_f64_vs_f64_ref"] = float((chunked - exact).abs().max())
    out["f64_ref_logits_max_abs"] = float(exact.abs().max())
    return out


def model_phase(dev, cfg, params) -> dict:
    """A full-width f32 model: the kernel path against force_ref, prefill
    plus 8 decode steps teacher-forced on the reference's greedy tokens;
    the kernel path's launches counted. For a scan family, also every
    scan in situ (scan_in_situ) and the f32 floor: the same comparison
    with each scan's plain version in place of its kernel, i.e. two exact
    f32 evaluations in other summation orders."""
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain
    from repro_torch.kernels.ssd_scan import ssd_scan_plain

    prompt = torch.as_tensor(np.arange(37) % 97 + 1, device=dev)[None]
    ref, toks = _greedy_run(cfg, params, prompt, True)
    reset_launches()
    ker, ker_toks = _greedy_run(cfg, params, prompt, False, teacher=toks)
    launches = dict(LAUNCHES)
    err = _max_err(ref, ker)
    agree = all(torch.equal(a[:, -1:].argmax(-1), b[:, -1:].argmax(-1))
                for a, b in zip(ref, ker))
    out = {"phase": "model", "arch": cfg.arch_id, "n_layers": cfg.n_layers,
           "dtype": "float32",
           "prompt_len": 37, "decode_steps": 8,
           "logits_max_abs_err": err,
           "logits_max_abs": max(float(x.abs().max()) for x in ref),
           "tol": LOGIT_TOL, "tol_reason": LOGIT_REASON,
           "greedy_tokens_agree": agree, "launches": launches}
    scan_family = cfg.backbone_kind != "attn"
    if scan_family:
        out["scan_in_situ"] = scan_in_situ(cfg, params, prompt)
        kernels = ops._rwkv, ops._ssd
        ops._rwkv, ops._ssd = rwkv6_scan_plain, ssd_scan_plain
        try:
            plain, _ = _greedy_run(cfg, params, prompt, False, teacher=toks)
        finally:
            ops._rwkv, ops._ssd = kernels
        out["plain_path_logits_max_abs_err"] = _max_err(ref, plain)
    if cfg.backbone_kind == "rwkv6":
        out["tol"] = RWKV_FLOOR_FACTOR * out["plain_path_logits_max_abs_err"]
        out["tol_reason"] = RWKV_LOGIT_REASON
        w = out["f64_witness"] = f64_witness(
            cfg, params, prompt,
            {"reference": ref[0], "kernel": ker[0], "plain": plain[0]})
    print(json.dumps(out))
    check(agree, f"{cfg.arch_id} model: greedy tokens differ")
    if cfg.backbone_kind == "attn":
        check_dense_launches(cfg, launches, f"{cfg.arch_id} model")
    if scan_family:
        check(out["scan_in_situ"]["ok"],
              f"{cfg.arch_id} model: a scan in situ is out of tolerance "
              f"{out['scan_in_situ']}")
    check(err <= out["tol"],
          f"{cfg.arch_id} model logits err {err} > {out['tol']}")
    if cfg.backbone_kind == "rwkv6":
        check(w["chunked_f64_vs_f64_ref"] <= LOGIT_TOL,
              f"{cfg.arch_id} model: the chunked scan in f64 is "
              f"{w['chunked_f64_vs_f64_ref']} from the f64 reference")
        f32_floor = max(w["reference_f32_vs_f64_ref"],
                        w["plain_f32_vs_f64_ref"])
        check(w["kernel_f32_vs_f64_ref"] <= RWKV_FLOOR_FACTOR * f32_floor,
              f"{cfg.arch_id} model: the kernel path is "
              f"{w['kernel_f32_vs_f64_ref']} from the f64 reference, over "
              f"{RWKV_FLOOR_FACTOR} x the f32 evaluations' {f32_floor}")
    return out


def check_dense_launches(cfg, launches: dict, where: str) -> None:
    """A dense model's kernel path launches flash and slot decode, and the
    FFN kernel exactly when its MLP is SwiGLU (a GELU MLP is PyTorch's
    matmuls, as in the JAX package)."""
    for name in ("flash_attention", "decode_attention"):
        check(launches.get(name, 0) > 0, f"{where}: {name} not launched")
    ffn = launches.get("fused_ffn", 0)
    check(ffn > 0 if cfg.gated_mlp else ffn == 0,
          f"{where}: fused_ffn launched {ffn} times, gated_mlp "
          f"{cfg.gated_mlp}")


def window_phase(dev, cfg, params) -> dict:
    """starcoder2-3b's sliding window at full width in f32: a prompt of
    SC_S tokens (past the window) prefilled into a ring of SC_WINDOW
    slots, then SC_STEPS decode steps, so flash masks each query's window
    and every decode step attends over a wrapped ring; the kernel path
    against force_ref, teacher-forced on the reference's greedy tokens:
    logits within LOGIT_TOL, tokens equal, flash once a layer and slot
    decode once a layer a step."""
    from repro_torch.kernels import LAUNCHES, reset_launches

    prompt = torch.as_tensor(np.arange(SC_S) % 97 + 1, device=dev)[None]
    kw = dict(capacity=SC_WINDOW, steps=SC_STEPS)
    ref, toks = _greedy_run(cfg, params, prompt, True, **kw)
    reset_launches()
    ker, _ = _greedy_run(cfg, params, prompt, False, teacher=toks, **kw)
    launches = dict(LAUNCHES)
    err = _max_err(ref, ker)
    agree = all(torch.equal(a[:, -1:].argmax(-1), b[:, -1:].argmax(-1))
                for a, b in zip(ref, ker))
    out = {"phase": "window_check", "arch": cfg.arch_id,
           "n_layers": cfg.n_layers, "dtype": "float32",
           "prompt_len": SC_S, "window": cfg.sliding_window,
           "ring_slots": SC_WINDOW, "decode_steps": SC_STEPS,
           "logits_max_abs_err": err,
           "logits_max_abs": max(float(x.abs().max()) for x in ref),
           "tol": LOGIT_TOL, "tol_reason": LOGIT_REASON,
           "greedy_tokens_agree": agree, "launches": launches}
    print(json.dumps(out))
    check(agree, f"{cfg.arch_id} window check: greedy tokens differ")
    check(err <= LOGIT_TOL,
          f"{cfg.arch_id} window check: logits err {err} > {LOGIT_TOL}")
    check(launches.get("flash_attention", 0) == cfg.n_layers,
          f"window check: flash launched {launches.get('flash_attention')}")
    check(launches.get("decode_attention", 0) == cfg.n_layers * SC_STEPS,
          f"window check: slot decode launched "
          f"{launches.get('decode_attention')} times")
    check(launches.get("fused_ffn", 0) == 0, "window check: FFN launched")
    return out


def paged_model_phase(dev, cfg, params) -> dict:
    """A full-width f32 dense model (qwen3-0.6b; qwen3-8b at its cut
    depth) on the paged path: two ragged prompts admitted by a paged
    engine (batched prefill, insert into the pool), then 8 paged decode
    steps, kernels against force_ref, teacher-forced on the reference's
    greedy tokens. A full-precision pool must launch the paged decode
    kernel once a layer a step; an int8 pool (gathered and dequantised)
    the slot decode kernel, and never the paged one."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import decode_step
    from repro_torch.serving import ContinuousBatchingEngine

    steps = 8
    int8 = cfg.kv_cache_dtype == "int8"
    eng = ContinuousBatchingEngine(cfg, params, max_slots=2, capacity=256,
                                   paged=True, block_size=16, n_blocks=32)
    prompts = [np.arange(37) % 97 + 1, np.arange(20) % 89 + 3]
    check(all(eng.admit_many([(0, prompts[0], 64, 8),
                              (1, prompts[1], 64, 8)])), "admission refused")
    # This phase runs decode_step itself, to hold the kernel path's logits
    # against force_ref's, so it makes the two calls step_chunk makes at a
    # chunk boundary: blocks for the next `steps` writes, then the table
    # copied to the device. The engine has no public call for them.
    eng._ensure_blocks(steps)
    eng._sync_tables()
    ck = eng.cache["layers"]
    cr = ck._replace(**{f: getattr(ck, f).clone()      # advanced in place
                        for f in ("k", "v", "k_scale", "v_scale", "length")
                        if getattr(ck, f) is not None})
    tok = torch.tensor([[s.last_token] for s in eng.slots], device=dev)
    err = scale = 0.0
    agree, tokens = True, []
    reset_launches()
    for _ in range(steps):
        r = decode_step(cfg, params, tok, {"layers": cr}, force_ref=True)
        k = decode_step(cfg, params, tok, {"layers": ck})
        err = max(err, float((r.logits - k.logits).abs().max()))
        scale = max(scale, float(r.logits.abs().max()))
        tok = r.logits[:, -1:].argmax(-1)
        agree &= bool(torch.equal(k.logits[:, -1:].argmax(-1), tok))
        tokens.append(tok[:, 0].tolist())
        cr, ck = r.cache["layers"], k.cache["layers"]
    decode = "decode_attention" if int8 else "paged_decode_attention"
    other = "paged_decode_attention" if int8 else "decode_attention"
    launches = LAUNCHES[decode]
    out = {"phase": "paged_model", "arch": cfg.arch_id,
           "n_layers": cfg.n_layers, "dtype": "float32",
           "kv_cache_dtype": cfg.kv_cache_dtype,
           "prompt_lens": [len(p) for p in prompts], "block_size": 16,
           "block_tables": ck.block_tables[:, :4].tolist(),
           "decode_steps": steps, "logits_max_abs_err": err,
           "logits_max_abs": scale, "tol": LOGIT_TOL,
           "tol_reason": LOGIT_REASON, "greedy_tokens_agree": agree,
           "greedy_tokens": tokens, "decode_kernel": decode,
           "decode_launches": launches, "other_launches": LAUNCHES[other]}
    print(json.dumps(out))
    check(err <= LOGIT_TOL, f"paged model logits err {err} > {LOGIT_TOL}")
    check(launches == steps * cfg.n_layers,
          f"{decode} launched {launches} times in {steps} steps of "
          f"{cfg.n_layers} layers")
    check(LAUNCHES[other] == 0, f"{other} launched on the paged model")
    return out


def int8_model_phase(dev, cfg32, params) -> dict:
    """The full-width f32 model with an int8 KV cache: on the slot cache,
    prefill plus 8 decode steps through the kernels against force_ref
    (logits within LOGIT_TOL, greedy tokens equal, the slot decode kernel
    once a layer a step), the int8 cache's logit gap from the
    full-precision cache on the same kernel path and tokens; then the
    paged pool (paged_model_phase)."""
    from repro_torch.kernels import LAUNCHES, reset_launches

    cfg8 = dataclasses.replace(cfg32, kv_cache_dtype="int8")
    prompt = torch.as_tensor(np.arange(37) % 97 + 1, device=dev)[None]
    ref, toks = _greedy_run(cfg8, params, prompt, True)
    reset_launches()
    ker, _ = _greedy_run(cfg8, params, prompt, False, teacher=toks)
    launches = dict(LAUNCHES)
    full, _ = _greedy_run(cfg32, params, prompt, False, teacher=toks)
    err = _max_err(ref, ker)
    agree = all(torch.equal(a[:, -1:].argmax(-1), b[:, -1:].argmax(-1))
                for a, b in zip(ref, ker))
    # decode steps only: the prefill's logits do not read the cache
    gap = _max_err(ker[1:], full[1:])
    out = {"phase": "int8_model", "arch": cfg8.arch_id,
           "n_layers": cfg8.n_layers, "dtype": "float32",
           "kv_cache_dtype": "int8", "prompt_len": 37, "decode_steps": 8,
           "logits_max_abs_err": err,
           "logits_max_abs": max(float(x.abs().max()) for x in ref),
           "tol": LOGIT_TOL, "tol_reason": LOGIT_REASON,
           "greedy_tokens_agree": agree,
           "int8_vs_full_cache_logits_max_abs_gap": gap,
           "int8_vs_full_cache_greedy_agree": all(
               torch.equal(a[:, -1:].argmax(-1), b[:, -1:].argmax(-1))
               for a, b in zip(ker, full)),
           "launches": launches}
    print(json.dumps(out))
    check(agree, "int8 model: greedy tokens differ")
    check(err <= LOGIT_TOL, f"int8 model logits err {err} > {LOGIT_TOL}")
    check(launches.get("decode_attention", 0) == 8 * cfg8.n_layers,
          f"int8 model: decode_attention launched "
          f"{launches.get('decode_attention', 0)} times in 8 steps")
    check(np.isfinite(gap), "int8 model: non-finite logits")
    out["paged"] = paged_model_phase(dev, cfg8, params)
    return out


def graph_stats(label: str, chunk: int, captures_before: int = 0) -> dict:
    """The decode graph's counts under ``label`` since the last reset:
    captures (``captures_before`` made by the warm-up before it), replays,
    steps (each capture's eager warm-up step plus the replays), chunks and
    host reads per chunk."""
    from repro_torch.obs import graph_hooks

    snap = graph_hooks.snapshot()
    captures = captures_before + snap["captures"].get(label, 0)
    replays = snap["replays"].get(label, 0)
    steps = snap["captures"].get(label, 0) + replays
    reads = snap["transfers"].get(label, 0)
    return {"label": label, "captures": captures, "replays": replays,
            "steps": steps, "chunks": steps / chunk, "host_reads": reads,
            "host_reads_per_chunk": reads / max(steps / chunk, 1e-9)}


def decode_launches_expected(cfg, steps: int) -> dict:
    """The decode kernels' launches ``steps`` decode steps make: slot
    decode once per attention layer (the hybrid: once per shared-block
    application) a step; none for RWKV6."""
    if cfg.has_shared_attn:
        return {"decode_attention": cfg.n_layers // cfg.attn_every * steps}
    if cfg.backbone_kind == "attn":
        return {"decode_attention": cfg.n_layers * steps}
    return {}


def serve_phase(dev, arch: str, kernels: tuple, mode: str = "virtual",
                n_layers=None, kv_cache_dtype: str = "model") -> dict:
    """The main path of ``arch`` at full width in bf16: allocator ->
    scheduler -> LLMServer -> DecodeEngine, whose chunks replay the
    captured decode step. Each of ``kernels`` must be launched on it, the
    decode graph captured once, the host read once per chunk, and the
    slot decode kernel's launches must equal one per attention layer per
    replayed step. Then the eager-vs-graph pin: the first two requests
    (budgets capped at PIN_BUDGET) through the eager per-token loop and
    the graph path, tokens equal. ``mode="wall"`` times each request on
    the host clock (the calibration's points). ``kv_cache_dtype="int8"``
    serves on the int8 cache and adds its KV bytes against the
    full-precision cache's and the dequantise's device time a step."""
    from repro_torch.configs import get_config
    from repro_torch.core import paper_problem
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import init_params
    from repro_torch.obs import graph_hooks
    from repro_torch.queueing_sim import generate_stream
    from repro_torch.serving import DecodeEngine, LLMServer, ServerConfig

    cfg = dataclasses.replace(get_config(arch),
                              kv_cache_dtype=kv_cache_dtype)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = init_params(cfg, seed=0, device=dev)
    params_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    engine = DecodeEngine(cfg, params, cache_capacity=2048, chunk=16)
    graph_hooks.reset()
    engine.generate(np.ones((1, 16), np.int32), [4], max_extra_tokens=0)
    warm_captures = graph_hooks.capture_counts().get("engine.chunk", 0)
    timers = {"prefill_s": 0.0, "generate_s": 0.0}
    prefill, generate = engine.prefill, engine.generate

    def timed_prefill(prompts):
        t0 = time.perf_counter()
        out = prefill(prompts)
        torch.cuda.synchronize()
        timers["prefill_s"] += time.perf_counter() - t0
        return out

    def timed_generate(*args, **kwargs):
        t0 = time.perf_counter()
        out = generate(*args, **kwargs)       # returns host arrays: synced
        timers["generate_s"] += time.perf_counter() - t0
        return out

    engine.prefill, engine.generate = timed_prefill, timed_generate
    prob = paper_problem(lam=0.1, alpha=30.0)
    stream = generate_stream(prob.tasks, 0.1, 8, seed=0)
    srv = LLMServer(prob, ServerConfig(generate_tokens=True, mode=mode),
                    engine=engine)
    sol = srv.allocator.solution
    allocation = dict(zip(prob.tasks.names,
                          sol.lengths_int.astype(int).tolist()))
    print("allocation:", json.dumps(allocation))
    graph_hooks.reset()
    reset_launches()
    t0 = time.perf_counter()
    rep = srv.run(stream)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    graph = graph_stats("engine.chunk", engine.chunk, warm_captures)
    extra = srv.cfg.max_extra_tokens
    for c in srv.completed:
        check(c.n_tokens == c.budget + extra,
              f"request {c.rid}: {c.n_tokens} tokens for budget "
              f"{c.budget} + {extra}")
    check(rep.n == 8, f"served {rep.n} of 8 requests")
    decode_s = timers["generate_s"] - timers["prefill_s"]
    out = {"phase": "serve", "arch": cfg.arch_id, "n_layers": cfg.n_layers,
           "dtype": cfg.dtype, "mode": mode,
           "kv_cache_dtype": cfg.kv_cache_dtype,
           "report": dataclasses.asdict(rep),
           "budgets_enforced_exactly": True,
           "wall_s": wall, "prefill_s": timers["prefill_s"],
           "decode_s": decode_s,
           "decode_tokens_per_s": rep.tokens_generated / decode_s,
           "graph": graph, "launches": launches,
           "params_gb": params_gb,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "prompt_lens": [q.prompt_len for q in stream.queries]}
    print(json.dumps(out))
    for name in kernels:
        check(launches.get(name, 0) > 0,
              f"{name} was launched 0 times on the {arch} main path")
    if cfg.backbone_kind == "attn":
        check_dense_launches(cfg, launches, f"{arch} serve")
    check(graph["captures"] == 1 and graph["host_reads_per_chunk"] == 1,
          f"{arch} serve: decode graph {graph}")
    for name, n in decode_launches_expected(cfg, graph["steps"]).items():
        check(launches.get(name, 0) == n,
              f"{arch} serve: {name} launched {launches.get(name, 0)} "
              f"times in {graph['steps']} replayed steps, expected {n}")
    engine.prefill, engine.generate = prefill, generate
    if cfg.kv_cache_dtype == "int8":
        out["kv_cache"] = int8_cache_cost(engine)
    out["pin"] = eager_graph_pin(engine, stream, srv.completed)
    print(json.dumps({**decode_step_breakdown(engine), "arch": arch,
                      "kv_cache_dtype": cfg.kv_cache_dtype}))
    out["completed"] = [(c.n_tokens, c.service_time) for c in srv.completed]
    return out


def int8_cache_cost(engine) -> dict:
    """The int8 serve's static cache: its bytes (codes and scales) against
    a full-precision cache of the same shape in the model's dtype, and the
    device time a decode step spends dequantising it (each layer's K and V
    of the whole 2048-slot cache, as the step does), profiled."""
    from repro_torch.models.attention import _dequantize

    (key, st), = engine._static.items()
    kv = st["cache"]["layers"]
    int8_bytes = sum(t.nbytes for t in (kv.k, kv.v, kv.k_scale, kv.v_scale))
    dtype = engine.cfg.tdtype
    full_bytes = 2 * kv.k.numel() * torch.empty((), dtype=dtype).element_size()
    L = kv.k.shape[0]

    def dequant():
        for i in range(L):
            _dequantize(kv.k[i], kv.k_scale[i], dtype)
            _dequantize(kv.v[i], kv.v_scale[i], dtype)
    for _ in range(2):
        dequant()
    prof = profile_steps(dequant, 4, 4)
    out = {"phase": "int8_kv_cache", "arch": engine.cfg.arch_id,
           "static_key": list(key), "shape": list(kv.k.shape),
           "int8_bytes": int8_bytes, "model_dtype_bytes": full_bytes,
           "bytes_ratio": int8_bytes / full_bytes,
           "dequantise_device_ms_per_step": prof["device_ms_per_step"],
           "dequantise_wall_ms_per_step": prof["wall_ms_per_step"]}
    print(json.dumps(out))
    hd, el = kv.k.shape[-1], torch.empty((), dtype=dtype).element_size()
    check(out["bytes_ratio"] == (hd + 4) / (hd * el),
          f"int8 cache bytes {out}")
    return out


def eager_graph_pin(engine, stream, completed, n: int = 2) -> dict:
    """The first ``n`` requests, budgets capped at PIN_BUDGET, through the
    eager per-token loop and through the replayed graph: greedy tokens
    equal; wall time and tokens/s of each (the same card, one process)."""
    budgets = {c.rid: c.budget for c in completed}
    rows = []
    for q in stream.queries[:n]:
        prompt = (np.arange(q.prompt_len) % 97 + 1)[None].astype(np.int32)
        budget = min(budgets[q.qid], PIN_BUDGET)
        row = {"rid": q.qid, "prompt_len": q.prompt_len, "budget": budget}
        for name, use_scan in (("eager_loop", False), ("graph", True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = engine.generate(prompt, [budget], max_extra_tokens=8,
                                  use_scan=use_scan)
            dt = time.perf_counter() - t0
            row[name] = {"s": dt, "tokens_per_s":
                         int(res["n_generated"][0]) / dt}
            row[name + "_tokens"] = res["tokens"][0].tolist()
        row["equal"] = row.pop("eager_loop_tokens") == row.pop("graph_tokens")
        rows.append(row)
    out = {"phase": "eager_graph_pin", "arch": engine.cfg.arch_id,
           "requests": rows}
    print(json.dumps(out))
    check(all(r["equal"] for r in rows),
          f"{engine.cfg.arch_id}: graph tokens differ from the eager loop")
    return out


def decode_step_breakdown(engine, steps: int = 16) -> dict:
    """Where a full-width decode step's time goes, eager and replayed, at
    position ~100 of a 2048-slot cache: host wall time per step
    (synchronised) against the device time of the kernels the profiler
    saw. The eager step is the per-token loop's; the graph step replays
    the engine's captured (1, chunk) step."""
    prompt = np.arange(96, dtype=np.int32)[None] % 97 + 1
    logits, cache = engine.prefill(prompt)
    state = {"token": logits.argmax(-1), "cache": cache}

    def eager():
        state["token"], state["cache"] = engine._step(
            state["token"], state["cache"], None)
    for _ in range(4):                               # warm
        eager()
    out = {"phase": "decode_step_breakdown",
           "eager": profile_steps(eager, steps, steps)}
    logits, cache = engine.prefill(prompt)
    big = np.array([10 ** 6], np.int32)
    key, _, step = engine._prepare(logits.argmax(-1), cache, big, big, None,
                                   engine.chunk)

    def replay():
        engine._graphs.run(key, step)
    for _ in range(4):
        replay()
    out["graph"] = profile_steps(replay, steps, steps)
    out["wall_speedup"] = (out["eager"]["wall_ms_per_step"]
                           / out["graph"]["wall_ms_per_step"])
    return out


def profile_steps(run, n_calls: int, steps: int) -> dict:
    """Host wall time per decode step of ``run`` (called ``n_calls`` times,
    ``steps`` decode steps in all, synchronised) against the device time
    of the kernels the profiler saw in a second, profiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_calls):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            run()
        torch.cuda.synchronize()
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:    # CPU ops would count twice
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            per_kernel[ev.key] = us / 1e3 / steps
    device_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": steps, "wall_ms_per_step": wall_ms,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "top_device_ms_per_step": {k[:80]: v for k, v in top}}


def _recording_groups(engine) -> list:
    """The engine's admission groups, as lists of request ids, recorded
    as it admits them."""
    groups = []
    admit_group = engine._admit_group

    def record(group):
        groups.append([req[0] for _, req in group])
        admit_group(group)
    engine._admit_group = record
    return groups


def continuous_serve_phase(dev, cfg, params, paged: bool = True) -> dict:
    """The continuous path: allocator -> scheduler -> LLMServer(batch_size
    8) -> ContinuousBatchingEngine (8 slots, capacity 2048, chunk 16; the
    paged pool in blocks of 16, or slot rows, a window's ring holding
    min(2048, window)), on the serve phase's stream, its chunks replaying
    the captured step. Exact budgets, one capture, one host read a chunk,
    admission groups of one prompt length where the backbone cannot pad,
    and the launches the groups and steps imply: a dense model's flash
    once a layer a group and its decode kernel (paged or slot) once a
    layer a replayed step; the family's scan once a layer a group; the
    hybrid's flash once a shared-block application a group and slot
    decode once an application a step."""
    from repro_torch.core import paper_problem
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.obs import graph_hooks
    from repro_torch.queueing_sim import generate_stream
    from repro_torch.serving import (ContinuousBatchingEngine, LLMServer,
                                     ServerConfig)

    engine = ContinuousBatchingEngine(cfg, params, max_slots=8,
                                      capacity=2048, chunk=16, paged=paged,
                                      block_size=16)
    label = engine._graphs.label
    graph_hooks.reset()
    engine.admit(-1, np.ones(16, np.int64), 4, 0)          # warm, capture
    while engine.n_active:
        engine.step_chunk()
    warm_captures = graph_hooks.capture_counts().get(label, 0)
    groups = _recording_groups(engine)
    prob = paper_problem(lam=0.1, alpha=30.0)
    stream = generate_stream(prob.tasks, 0.1, 8, seed=0)
    srv = LLMServer(prob, ServerConfig(generate_tokens=True, batch_size=8),
                    engine=engine)
    graph_hooks.reset()
    reset_launches()
    t0 = time.perf_counter()
    rep = srv.run(stream)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    graph = graph_stats(label, engine.chunk, warm_captures)
    extra = srv.cfg.max_extra_tokens
    for c in srv.completed:
        check(c.n_tokens == c.budget + extra,
              f"request {c.rid}: {c.n_tokens} tokens for budget "
              f"{c.budget} + {extra}")
    check(rep.n == 8, f"served {rep.n} of 8 requests")
    lengths = {q.qid: q.prompt_len for q in stream.queries}
    if not engine._can_pad_batch():
        check(all(len({lengths[r] for r in g}) == 1 for g in groups),
              f"{cfg.arch_id}: an admission group mixes prompt lengths "
              f"{groups}")
    n_groups, steps = len(groups), graph["steps"]
    if cfg.has_shared_attn:
        g = cfg.n_layers // cfg.attn_every
        expected = {"ssd_scan": cfg.n_layers * n_groups,
                    "flash_attention": g * n_groups,
                    "decode_attention": g * steps}
    elif cfg.backbone_kind == "rwkv6":
        expected = {"rwkv6_scan": cfg.n_layers * n_groups}
    else:
        decode = "paged_decode_attention" if paged else "decode_attention"
        expected = {"flash_attention": cfg.n_layers * n_groups,
                    decode: cfg.n_layers * steps}
    kv = engine.cache.get("layers", engine.cache.get("shared"))
    out = {"phase": "continuous_serve", "arch": cfg.arch_id,
           "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "engine": f"ContinuousBatchingEngine(paged={paged}, max_slots=8, "
                     "capacity=2048, chunk=16"
                     + (", block_size=16)" if paged else ")"),
           "batch_size": 8,
           "kv_positions_a_row": getattr(kv, "capacity", None),
           "report": dataclasses.asdict(rep),
           "budgets_enforced_exactly": True, "wall_s": wall,
           "admission_groups": groups, "decode_steps": steps,
           "graph": graph, "tokens_per_s": rep.tokens_generated / wall,
           "launches": launches, "launches_expected": expected}
    print(json.dumps(out))
    check(graph["captures"] == 1 and graph["host_reads_per_chunk"] == 1,
          f"{cfg.arch_id} continuous serve: decode graph {graph}")
    for name, n in expected.items():
        check(launches.get(name, 0) == n,
              f"{cfg.arch_id} continuous serve: {name} launched "
              f"{launches.get(name, 0)} times, expected {n}")
    if cfg.backbone_kind == "attn" or cfg.has_shared_attn:
        check((launches.get("fused_ffn", 0) > 0) == cfg.gated_mlp,
              f"{cfg.arch_id} continuous serve: fused_ffn launched "
              f"{launches.get('fused_ffn', 0)} times")
    out["budgets"] = {c.rid: c.budget for c in srv.completed}
    out["stream"] = stream
    return out


def rolling_drain_phase(dev, cfg, params, served, n_blocks: int = 64,
                        int8: bool = False) -> dict:
    """All 8 requests offered at once to a paged engine whose pool holds
    fewer tokens than they need (back-pressure); the same drain in slot
    mode, which admits them all at once; and the slot drain again, offered
    the paged drain's admission groups at the paged drain's chunks, so the
    two modes differ only in their attention kernel. Each drain's kernel
    launches are counted. Then a profiled chunk at 8 live slots in paged
    and slot mode. ``int8=True``: both on an int8 KV cache, the paged
    drain and the slot drain on its groups only, each launching the slot
    decode kernel and never the paged one, their tokens equal (an int8
    pool is gathered and dequantised, so the two modes attend over the
    same values through the same kernel); no profiled chunk."""
    import math

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.obs import graph_hooks
    from repro_torch.serving import ContinuousBatchingEngine

    if int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    budgets = served["budgets"]
    reqs = [(q.qid, np.arange(q.prompt_len) % 97 + 1, budgets[q.qid], 8)
            for q in served["stream"].queries]
    need = [r[1].size + r[2] + r[3] - 1 for r in reqs]
    out = {"phase": "rolling_drain", "arch": cfg.arch_id,
           "n_layers": cfg.n_layers, "kv_cache_dtype": cfg.kv_cache_dtype,
           "requests": len(reqs),
           "tokens_needed": sum(need),
           "blocks_needed": sum(math.ceil(n / 16) for n in need),
           "pool_blocks": n_blocks, "pool_tokens": n_blocks * 16}
    tokens, groups = {}, {}          # groups: chunk -> rids admitted there
    modes = (("paged", "slot_paged_groups") if int8
             else ("paged", "slot", "slot_paged_groups"))
    for mode in modes:
        paged = mode == "paged"
        eng = ContinuousBatchingEngine(
            cfg, params, max_slots=8, capacity=2048, chunk=16, paged=paged,
            block_size=16, n_blocks=n_blocks)
        pending, done, refused, chunks, peak = list(reqs), {}, [], 0, 0
        torch.cuda.synchronize()
        graph_hooks.reset()
        reset_launches()
        t0 = time.perf_counter()
        while pending or eng.n_active:
            offer = pending
            if mode == "slot_paged_groups":
                offer = [r for r in pending if r[0] in groups.get(chunks, ())]
            if offer:
                flags = eng.admit_many(offer)
                admitted = [r[0] for r, ok in zip(offer, flags) if ok]
                refused.append(len(offer) - len(admitted))
                if paged and admitted:
                    groups[chunks] = admitted
                check(mode != "slot_paged_groups" or not refused[-1],
                      f"slot drain refused a paged admission group {offer}")
                pending = [r for r in pending if r[0] not in admitted]
            peak = max(peak, eng.tokens_in_use)
            for s in eng.step_chunk():
                done[s.rid] = s.tokens
            chunks += 1
            check(chunks <= 1000, f"{mode} drain did not end")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        graph = graph_stats(eng._graphs.label, 16)
        check(graph["captures"] == 1 and graph["host_reads_per_chunk"] == 1,
              f"{mode} drain: decode graph {graph}")
        for rid, _, budget, extra in reqs:
            check(len(done[rid]) == budget + extra,
                  f"{mode} drain: request {rid} got {len(done[rid])} tokens "
                  f"for budget {budget} + {extra}")
        decode = ("paged_decode_attention" if paged and not int8
                  else "decode_attention")
        other = ("decode_attention" if decode == "paged_decode_attention"
                 else "paged_decode_attention")
        for name in ("flash_attention", "fused_ffn", decode):
            check(launches.get(name, 0) > 0,
                  f"{name} was launched 0 times in the {mode} drain")
        check(launches.get(other, 0) == 0,
              f"{other} was launched in the {mode} drain")
        tokens[mode] = done
        check(launches.get(decode, 0) == cfg.n_layers * graph["steps"],
              f"{mode} drain: {decode} launched {launches.get(decode, 0)} "
              f"times "
              f"in {graph['steps']} replayed steps")
        row = {"wall_s": wall, "chunks": chunks,
               "tokens_per_s": sum(map(len, done.values())) / wall,
               "refused_per_admission": refused,
               "peak_tokens_in_use": peak, "graph": graph,
               "launches": launches}
        if paged:
            check(refused[0] > 0, "the paged pool admitted every request "
                  "at once: no back-pressure")
            # with no duplicate or out-of-range block on the free list, a
            # free list of n_blocks entries holds every block
            check(eng.check_block_invariants(), "block invariants")
            check(eng.allocator.n_free == n_blocks
                  and eng.allocator.reserved == 0,
                  "free list not restored after the drain")
            row["free_list_restored"] = True
            row["admission_groups"] = {str(c): g for c, g in groups.items()}
        if mode != "slot_paged_groups" and not int8:
            # one profiled chunk of 16 steps at 8 live slots, positions ~100
            # (8 requests of 96 + 31 tokens fill the 64-block pool exactly),
            # replayed; then with the step run eagerly (a cache whose device
            # says CPU captures nothing), the step before the graph
            for name in ("breakdown_8_slots", "breakdown_8_slots_eager"):
                if name.endswith("eager"):
                    eng._graphs = graph_hooks.GraphCache("eager", "cpu")
                check(all(eng.admit_many(
                    [(1000 + i, np.arange(96) % 97 + 1, 32, 0)
                     for i in range(8)])),
                    f"{mode}: 8 profiling requests not admitted")
                row[name] = profile_steps(
                    lambda eng=eng: eng.step_chunk(16), 1, 16)
                while eng.n_active:
                    eng.step_chunk()
        out[mode] = row
        del eng
        torch.cuda.empty_cache()

    def agreeing(a, b):
        return sum(tokens[a][rid] == tokens[b][rid] for rid in tokens[a])
    out["requests_agreeing_same_groups"] = agreeing("paged",
                                                    "slot_paged_groups")
    if int8:
        print(json.dumps(out))
        check(out["requests_agreeing_same_groups"] == len(reqs),
              "int8 drain: paged tokens differ from the slot drain's on the "
              "same admission groups")
        return out
    # reported, not asserted: see the module docstring
    out["requests_agreeing"] = agreeing("paged", "slot")
    out["bf16_tokens_agree_paged_vs_slot"] = (
        out["requests_agreeing"] == len(reqs))
    print(json.dumps(out))
    return out


def _hooked_run(engine, prob, stream, obs: bool, hooks: bool = True):
    """One run of ``stream`` through LLMServer(batch_size=8) on ``engine``,
    virtual clock, real tokens. With ``hooks``: an admission ladder on the
    deployed budgets (an allocator whose rate estimate follows the stream
    within a few arrivals and never re-solves, so the ladder, not the
    re-solver, answers the overload), PoolPressure and StragglerDecode;
    with ``obs`` also a Tracer (the engine's too) and a MetricsRegistry.
    Every hook object is made anew from its seed, so runs repeat."""
    from repro_torch import faults
    from repro_torch.core import TokenBudgetAllocator
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.serving import (AdmissionConfig, AdmissionController,
                                     LLMServer, ServerConfig)

    alloc = TokenBudgetAllocator(prob, ewma_halflife=2.0,
                                 min_resolve_interval=10 ** 9)
    kw = {"allocator": alloc}
    if hooks:
        kw["admission"] = AdmissionController(
            alloc.solution.lengths_int, prob.server.l_max,
            AdmissionConfig(n_levels=3, rho_high=0.9, rho_low=0.7,
                            dwell_down=1e9))
        kw["faults"] = faults.FaultSet(
            faults.PoolPressure(0.3, hold_steps=4, period_steps=8, seed=8),
            faults.StragglerDecode(0.25, 3.0, seed=4))
    if obs:
        kw["tracer"], kw["metrics"] = Tracer(), MetricsRegistry()
    engine.tracer = kw.get("tracer")
    engine.faults = None                 # the server hands its own over
    srv = LLMServer(prob, ServerConfig(generate_tokens=True, batch_size=8),
                    engine=engine, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = srv.run(stream)
    torch.cuda.synchronize()
    return srv, rep, time.perf_counter() - t0


def hooks_serve_phase(dev, cfg, params) -> dict:
    """The server's hooks on the card: LLMServer(batch_size=8) over the
    paged continuous engine (64 blocks, as the drains), virtual clock,
    real tokens, with the admission ladder, PoolPressure and
    StragglerDecode, a Tracer and a MetricsRegistry, on HOOKS_QUERIES
    queries of generate_stream at 2x the service rate of the deployed
    budgets (reference tests/test_faults.py's overload). Checks: every
    completed request's span tree, sheds (zero tokens), exact budgets
    within the level-0 caps and some degraded, the pool's audit and a
    balanced allocator after release, one capture across the ladder's
    budget changes. Then the same run without the tracer and metrics
    (the same decisions and tokens) and without any hook (full budgets,
    other work), one after the other, for the hooks' cost."""
    from repro_torch.core import paper_problem, solve
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.obs import graph_hooks, validate_request_trees
    from repro_torch.queueing_sim import generate_stream
    from repro_torch.serving import ContinuousBatchingEngine

    prob = paper_problem(lam=0.1, alpha=30.0)
    tasks = prob.tasks
    deployed = solve(prob).lengths_int.astype(np.float64)
    es = float((tasks.pi.numpy() * (tasks.t0.numpy()
                                    + tasks.c.numpy() * deployed)).sum())
    stream = generate_stream(tasks, 2.0 / es, HOOKS_QUERIES, seed=0)
    engine = ContinuousBatchingEngine(cfg, params, max_slots=8,
                                      capacity=2048, chunk=16, paged=True,
                                      block_size=16, n_blocks=64)
    graph_hooks.reset()
    reset_launches()
    srv, rep, wall = _hooked_run(engine, prob, stream, obs=True)
    launches = dict(LAUNCHES)
    graph = graph_stats("continuous.paged", engine.chunk)
    trace = srv.tracer.to_chrome()
    extra = srv.cfg.max_extra_tokens
    ladder = srv.admission.ladder()
    for c in srv.completed:
        check(c.n_tokens == c.budget + extra,
              f"hooks serve: request {c.rid}: {c.n_tokens} tokens for "
              f"budget {c.budget} + {extra}")
        check(c.budget <= ladder[0, c.task_index],
              f"hooks serve: request {c.rid} budget {c.budget} over its cap")
    check(all(c.n_tokens == 0 and c.service_time == 0.0 for c in srv.shed),
          "hooks serve: a shed request has tokens or service")
    trees = validate_request_trees(trace, [c.rid for c in srv.completed])
    check(engine.check_block_invariants(), "hooks serve: block invariants")
    srv.faults.release_all(engine)
    check(engine.allocator.n_free == engine.allocator.n_blocks
          and engine.allocator.reserved == 0,
          "hooks serve: allocator not balanced after release")
    degraded = sum(c.budget < ladder[0, c.task_index]
                   for c in srv.completed)

    def spans(name):
        ms = [ev["dur"] / 1e3 for ev in trace["traceEvents"]
              if ev.get("name") == name and ev["ph"] == "X"]
        return {"n": len(ms), "total_ms": float(np.sum(ms)),
                "mean_ms": float(np.mean(ms)) if ms else 0.0,
                "p50_ms": float(np.median(ms)) if ms else 0.0,
                "max_ms": float(np.max(ms)) if ms else 0.0}
    snap = srv.metrics.as_dict()
    tokens = [(c.rid, c.n_tokens) for c in srv.completed]
    runs = {"hooks_and_obs": wall}
    for name, obs, hooks in (("hooks_no_obs", False, True),
                             ("hooks_and_obs_again", True, True),
                             ("hooks_no_obs_again", False, True),
                             ("no_hooks", False, False)):
        s2, r2, w2 = _hooked_run(engine, prob, stream, obs=obs, hooks=hooks)
        runs[name] = w2
        if hooks:
            check([(c.rid, c.n_tokens) for c in s2.completed] == tokens
                  and r2.n_shed == rep.n_shed,
                  f"hooks serve: run {name} decided otherwise")
            s2.faults.release_all(engine)
        else:
            runs["no_hooks_tokens"] = r2.tokens_generated
    out = {"phase": "hooks_serve", "arch": cfg.arch_id,
           "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "engine": "ContinuousBatchingEngine(paged=True, max_slots=8, "
                     "capacity=2048, block_size=16, n_blocks=64, chunk=16)",
           "queries": HOOKS_QUERIES, "rate": 2.0 / es,
           "anchored_mean_service_s": es,
           "report": dataclasses.asdict(rep),
           "admission": {k: v for k, v in srv.admission.snapshot().items()
                         if k != "occupancy"},
           "degraded_requests": int(degraded),
           "shed_rids": [c.rid for c in srv.shed],
           "trees": trees,
           "metrics": {k: snap[k] for k in ("server.wait",
                                            "server.system_time",
                                            "server.tokens_in_use",
                                            "server.batches",
                                            "server.shed")
                       if k in snap},
           "wall_spans": {n: spans(n) for n in ("continuous.admit",
                                                 "continuous.decode_chunk")},
           "graph": graph, "launches": launches,
           "wall_s": runs, "tokens_with_hooks": rep.tokens_generated}
    print(json.dumps(out))
    check(rep.n_shed > 0 and rep.n + rep.n_shed == HOOKS_QUERIES,
          f"hooks serve: {rep.n_shed} shed of {HOOKS_QUERIES}")
    check(degraded > 0, "hooks serve: no budget was degraded")
    check(graph_hooks.capture_counts().get("continuous.paged", 0) == 1,
          f"hooks serve: {graph_hooks.capture_counts()} captures across the "
          f"ladder's budgets")
    check(graph["host_reads_per_chunk"] == 1, f"hooks serve: {graph}")
    check(launches.get("paged_decode_attention", 0)
          == cfg.n_layers * graph["steps"],
          f"hooks serve: paged decode launched "
          f"{launches.get('paged_decode_attention', 0)} times in "
          f"{graph['steps']} steps")
    return out


def recurrent_drain_phase(dev, arch: str) -> dict:
    """Rows of a recurrent or hybrid model admitted four at a time: the
    serve stream's 8 prompts (each shifted by its query id, so no two rows
    are equal) cut to two lengths, the four shortest to the shortest
    length and the rest to the fifth shortest, so each admission group
    runs its family's scan at B = 4. In f32 at a cut depth (rwkv6 at 4 of
    24 layers, the hybrid at one shared-block group plus its remainder),
    on a slot engine of 8 rows whose step runs eagerly so each step's
    logits can be read: every row's first 8 decode logits within
    LOGIT_TOL of the same prompt served alone through DecodeEngine's
    per-token loop, and all its tokens equal."""
    from repro_torch.configs import get_config
    from repro_torch.core import paper_problem
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    from repro_torch.models import init_params
    from repro_torch.obs import graph_hooks
    from repro_torch.queueing_sim import generate_stream
    from repro_torch.serving import (ContinuousBatchingEngine, DecodeEngine,
                                     continuous, engine)

    cfg = get_config(arch)
    n_layers = (4 if cfg.backbone_kind == "rwkv6"
                else cfg.attn_every + cfg.n_layers % cfg.attn_every)
    cfg = dataclasses.replace(cfg, dtype="float32", n_layers=n_layers)
    params = init_params(cfg, seed=0, device=dev)
    queries = sorted(generate_stream(paper_problem(lam=0.1, alpha=30.0)
                                     .tasks, 0.1, 8, seed=0).queries,
                     key=lambda q: q.prompt_len)
    cut = [queries[0].prompt_len] * 4 + [queries[4].prompt_len] * 4
    reqs = [(q.qid, (np.arange(n) + q.qid) % 97 + 1, DRAIN_BUDGET, 0)
            for q, n in zip(queries, cut)]
    scan = "rwkv6_scan" if cfg.backbone_kind == "rwkv6" else "ssd_scan"
    scan_fn = getattr(ops, scan)
    scan_batches = []

    def counted_scan(*args, **kwargs):
        scan_batches.append(args[0].shape[0])
        return scan_fn(*args, **kwargs)

    def recorder(module, steps):
        step_fn = module.decode_step

        def recorded(*args, **kwargs):
            res = step_fn(*args, **kwargs)
            steps.append(res.logits[:, 0].clone())
            return res
        return step_fn, recorded

    alone = {}
    eng1 = DecodeEngine(cfg, params, cache_capacity=256, chunk=16)
    for rid, prompt, budget, _ in reqs:
        steps = []
        orig, engine.decode_step = recorder(engine, steps)
        try:
            res = eng1.generate(prompt[None].astype(np.int32), [budget],
                                max_extra_tokens=0, use_scan=False)
        finally:
            engine.decode_step = orig
        alone[rid] = (res["tokens"][0].tolist(), steps)
    del eng1
    cont = ContinuousBatchingEngine(cfg, params, max_slots=8, capacity=256,
                                    chunk=16)
    cont._graphs = graph_hooks.GraphCache("eager", "cpu")
    groups = _recording_groups(cont)
    steps = []
    orig, continuous.decode_step = recorder(continuous, steps)
    setattr(ops, scan, counted_scan)
    reset_launches()
    try:
        check(all(cont.admit_many(reqs)), f"{arch} drain: not admitted")
        launches_admit = dict(LAUNCHES)
        slot_of = {s.rid: i for i, s in enumerate(cont.slots)}
        done = {}
        while cont.n_active:
            for s in cont.step_chunk():
                done[s.rid] = s.tokens
    finally:
        continuous.decode_step = orig
        setattr(ops, scan, scan_fn)
    launches = dict(LAUNCHES)
    rows = []
    for rid, prompt, _, _ in reqs:
        want_toks, want_logits = alone[rid]
        err = max(float((steps[i][slot_of[rid]] - want_logits[i][0])
                        .abs().max()) for i in range(8))
        rows.append({"rid": rid, "prompt_len": len(prompt),
                     "slot": slot_of[rid], "logits_max_abs_err": err,
                     "tokens_equal": done[rid] == want_toks})
    out = {"phase": "recurrent_drain", "arch": arch, "n_layers": n_layers,
           "dtype": "float32", "budget": DRAIN_BUDGET,
           "admission_groups": groups, "scan_batch_sizes": scan_batches,
           "rows": rows, "tol": LOGIT_TOL,
           "tol_reason": "each row's decode logits against the same prompt "
                         "served alone; " + LOGIT_REASON,
           "launches_at_admission": launches_admit, "launches": launches}
    print(json.dumps(out))
    check(len(groups) == 2 and all(len(g) == 4 for g in groups),
          f"{arch} drain: admission groups {groups}")
    check(scan_batches == [SCAN_GROUP_B] * (2 * n_layers),
          f"{arch} drain: scans at batch sizes {scan_batches}")
    check(launches_admit.get(scan, 0) == 2 * n_layers,
          f"{arch} drain: {scan} launched {launches_admit.get(scan, 0)} "
          f"times at admission")
    for r in rows:
        check(r["tokens_equal"], f"{arch} drain: row {r} tokens differ")
        check(r["logits_max_abs_err"] <= LOGIT_TOL,
              f"{arch} drain: row {r} logits off")
    return out


def step_latency_points(dev, cfg, params) -> dict:
    """The continuous engine's replayed decode step at occupancies 1, 2, 4
    and 8: for each b a paged engine of b slots, all live (prompts of 96
    tokens), one chunk of 16 to warm and capture, then the mean step of two
    synchronised chunks on the host clock (its one host read and the
    inputs' copy included, as a serving chunk has them)."""
    from repro_torch.serving import ContinuousBatchingEngine

    points = []
    for b in OCCUPANCIES:
        eng = ContinuousBatchingEngine(cfg, params, max_slots=b,
                                       capacity=2048, chunk=16, paged=True,
                                       block_size=16)
        check(all(eng.admit_many([(i, np.arange(96) % 97 + 1, 200, 0)
                                  for i in range(b)])),
              f"occupancy {b}: not admitted")
        eng.step_chunk()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            eng.step_chunk()
        points.append((b, (time.perf_counter() - t0) / 32))
        check(eng.n_active == b, f"occupancy {b}: a slot retired early")
        del eng
    out = {"phase": "step_latency_points", "arch": cfg.arch_id,
           "n_layers": cfg.n_layers, "engine": "ContinuousBatchingEngine("
           "paged=True, max_slots=b, capacity=2048, block_size=16, chunk=16)",
           "points_b_s": points}
    print(json.dumps(out))
    return out


def calibration_phase(served_8b: dict, occupancy: dict) -> dict:
    """The paper's constants fitted to this card: ``fit_latency`` to the
    qwen3-8b wall-mode serve's per-request (tokens, seconds),
    ``fit_step_latency`` to the continuous engine's step at occupancies
    1-8; then ``paper_problem`` solved again with every task's t0 and c
    set to the fit, its budgets beside the paper's, and the occupancy
    fixed point of the fitted step model at the fitted constants."""
    from repro_torch.core import (PAPER_TABLE1_LSTAR, Problem, TaskSet,
                                  batch_service_wait, fit_latency,
                                  fit_step_latency, paper_problem, solve)

    pts = served_8b["completed"]
    lat = fit_latency([n for n, _ in pts], [t for _, t in pts])
    b, t = zip(*occupancy["points_b_s"])
    step = fit_step_latency(b, t)
    paper = paper_problem(lam=0.1, alpha=30.0)
    n = paper.tasks.n_tasks
    tasks = TaskSet(names=paper.tasks.names, A=paper.tasks.A,
                    b=paper.tasks.b, D=paper.tasks.D,
                    t0=np.full(n, lat.t0), c=np.full(n, lat.c),
                    pi=paper.tasks.pi)
    fitted = Problem(tasks=tasks, server=paper.server)
    sol, sol_paper = solve(fitted), solve(paper)
    wait = batch_service_wait(tasks, sol.lengths_int, 0.1, step, 8)
    out = {"phase": "calibration", "card_fit": {
        "latency": {"arch": served_8b["arch"], "points_tokens_s": pts,
                    "t0_s": lat.t0, "c_s_per_token": lat.c,
                    "rmse_s": lat.rmse},
        "step": {"arch": occupancy["arch"], "n_layers":
                 occupancy["n_layers"], "d0_s": step.d0, "d1_s": step.d1}},
        "budgets": {"tasks": list(paper.tasks.names),
                    "card_fit_int": sol.lengths_int.astype(int).tolist(),
                    "card_fit_cont": sol.lengths_cont.tolist(),
                    "paper_constants_int":
                        sol_paper.lengths_int.astype(int).tolist(),
                    "paper_table1_lstar": list(PAPER_TABLE1_LSTAR)},
        "objective_card_fit": sol.value_int,
        "occupancy_at_card_fit": {"max_batch": 8, "b_bar": wait.b_bar,
                                  "ratio": wait.ratio,
                                  "mean_wait_s": wait.mean_wait}}
    print(json.dumps(out))
    check(lat.c > 0 and np.isfinite(lat.rmse), "latency fit failed")
    check(bool(np.all(np.isfinite(sol.lengths_cont))), "re-solve failed")
    return out


REPLACES = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:98"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:170"),
    "paged_decode_attention": (
        "src/repro_torch/csrc/paged_decode_attention.cu",
        "src/repro/kernels/decode_attention.py:114"),
    "fused_ffn": ("src/repro_torch/csrc/fused_ffn.cu",
                  "src/repro/kernels/fused_ffn.py:57"),
    "rwkv6_scan": ("src/repro_torch/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan.py:73"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:77"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False     # f32 means f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    per_source = _build.build()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "per_source_s": per_source}))

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    _, summary = kernel_cases(dev, flush)
    del flush

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    def f32_model(arch, n_layers=None):
        cfg32 = dataclasses.replace(get_config(arch), dtype="float32")
        if n_layers is not None:
            cfg32 = dataclasses.replace(cfg32, n_layers=n_layers)
        return cfg32, init_params(cfg32, seed=0, device=dev)

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def slot_serve(arch):
        """``arch`` in bf16 at full width through the slot continuous
        engine; its launches."""
        cfg = get_config(arch)
        params = init_params(cfg, seed=0, device=dev)
        return continuous_serve_phase(dev, cfg, params,
                                      paged=False)["launches"]

    cfg32, params32 = f32_model("qwen3-0.6b")
    model_phase(dev, cfg32, params32)
    paged_model_phase(dev, cfg32, params32)
    int8_model_phase(dev, cfg32, params32)
    del params32
    free()

    attn_kernels = ("flash_attention", "decode_attention", "fused_ffn")
    served = serve_phase(dev, "qwen3-0.6b", attn_kernels)
    free()
    served8 = serve_phase(dev, "qwen3-0.6b", attn_kernels,
                          kv_cache_dtype="int8")
    free()
    cfg = dataclasses.replace(get_config("qwen3-0.6b"),
                              n_layers=QWEN3_BATCHED_LAYERS)
    params = init_params(cfg, seed=0, device=dev)
    continuous = continuous_serve_phase(dev, cfg, params)
    rolling_drain_phase(dev, cfg, params, continuous)
    drain8 = rolling_drain_phase(dev, cfg, params, continuous, int8=True)
    hooks = hooks_serve_phase(dev, cfg, params)
    occupancy = step_latency_points(dev, cfg, params)
    del params
    free()

    # the recurrent and hybrid paths, then the paper's model: each model
    # freed before the next
    by_path = {"qwen3-0.6b serve": served["launches"],
               "qwen3-0.6b continuous serve": continuous["launches"],
               "qwen3-0.6b int8 serve": served8["launches"],
               "qwen3-0.6b int8 paged drain": drain8["paged"]["launches"],
               "qwen3-0.6b hooks serve": hooks["launches"]}
    for arch, kernels in (("rwkv6-1.6b", ("rwkv6_scan",)),
                          ("zamba2-7b", ("ssd_scan",) + attn_kernels)):
        cfg32, params32 = f32_model(arch)
        model_phase(dev, cfg32, params32)
        del params32
        free()
        by_path[f"{arch} serve"] = serve_phase(dev, arch, kernels)["launches"]
        free()
        by_path[f"{arch} continuous serve"] = slot_serve(arch)
        free()
        by_path[f"{arch} recurrent drain"] = recurrent_drain_phase(
            dev, arch)["launches"]
        free()
    # the other dense ids: LayerNorm without parameters (olmo-1b),
    # LayerNorm (stablelm-3b), LayerNorm, GELU MLP and a sliding window
    # (starcoder2-3b, also through the continuous engine)
    for arch in ("olmo-1b", "stablelm-3b", "starcoder2-3b"):
        cfg32, params32 = f32_model(arch)
        model_phase(dev, cfg32, params32)
        if cfg32.sliding_window is not None:
            by_path[f"{arch} window check"] = window_phase(
                dev, cfg32, params32)["launches"]
        del params32
        free()
        kernels = ("flash_attention", "decode_attention") + (
            ("fused_ffn",) if cfg32.gated_mlp else ())
        by_path[f"{arch} serve"] = serve_phase(dev, arch, kernels)["launches"]
        free()
    by_path["starcoder2-3b continuous serve"] = slot_serve("starcoder2-3b")
    free()
    cfg32, params32 = f32_model("qwen3-8b", n_layers=QWEN3_8B_F32_LAYERS)
    model_phase(dev, cfg32, params32)
    paged_model_phase(dev, cfg32, params32)
    del params32
    free()
    served_8b = serve_phase(dev, "qwen3-8b", attn_kernels, mode="wall")
    by_path["qwen3-8b serve"] = served_8b["launches"]
    free()
    calibration_phase(served_8b, occupancy)
    # each kernel's launches on the path that runs it: the slot kernels on
    # qwen3's DecodeEngine serve, the paged kernel on the continuous serve,
    # each scan on its family's serve
    launches = {**served["launches"], "paged_decode_attention":
                continuous["launches"]["paged_decode_attention"],
                "rwkv6_scan": by_path["rwkv6-1.6b serve"]["rwkv6_scan"],
                "ssd_scan": by_path["zamba2-7b serve"]["ssd_scan"]}

    kernels = []
    for name, (source, replaces) in REPLACES.items():
        row = summary[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": (row["library_ms"]
                                       if row["library_one_call"] else None),
                        **({} if row["library_one_call"] or
                           row["library_ms"] is None else
                           {"chain_ms": row["library_ms"]}),
                        "launches_by_path": {
                            path: counts[name]
                            for path, counts in by_path.items()
                            if counts.get(name)}})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
