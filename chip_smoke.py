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
   d 4096 / d_ff 12288 (flash also at S 8, the replay engine lane's
   prefill); flash on a padded admission group of
   8 x 113 and the FFN at T = 8, the continuous engine's 8 decode slots,
   and at the largest T the drains' batched admission prefills, group
   size x padded length, printed; starcoder2-3b's flash at S 4200 with
   its window of 4096 and G 12 and its slot decode over a ring of 4096,
   full and wrapping past slot 0; stablelm-3b's head width 80 at G 1 in
   flash and slot decode; zamba2-7b-instruct's shared blocks (32 heads
   of 224, scale 112^-0.5) in flash (S 16-128, and a group of 7 rows)
   and paged decode (8 ragged slots, and its cell's 64 rows at the deep
   mix's contexts), and its SSD scan with B/C in 2 groups (one launch a
   group's 56 heads, against the plain version on B/C per head); the
   FFN at T = 1 at olmo-1b's and stablelm-3b's widths and at
   deepseek-moe-16b's shared experts (d 2048, d_ff 2816);
   the FFN over the MoE's expert buffers [E, C, d], deepseek-moe-16b's 64
   experts (d 2048, d_ff 1408, top-6) and granite-moe-3b-a800m's 40 (d
   1536, d_ff 512, top-8), at C = T = 1 and 8 (dropless decode) and at a
   113-token prompt's capacity (C 13 and 28), tokens routed at random,
   with per-expert live rows (held on the live rows; the bound counts the
   hit experts' weights only) and without; both scans at B = 4, S = 64, a
   continuous admission group; the distribution steps' shapes: flash at
   B 2 x S 32,768 (held on 256 query rows) at qwen3-8b's G 4 and
   zamba2-7b's G 1, hd 112, slot decode at B 8 over 32,768 slots at
   both (and with a dominant slot in the last split), the FFN at T
   65,536 at both widths, long_500k's ring of 8,192, and both scans at
   B 2 x S 32,768; the MoE's pair ranks (``moe_ranks``, bit-equal to
   the plain version, the one-hot's cumulative count it replaced) at
   deepseek-moe-16b's E 64 top-6 over 384, 3,072 and 15,000 pairs and
   granite-moe-3b-a800m's E 40 top-8 over 512, ranks alone, with the
   prefill capacity's buffer rows and at decode's C = T),
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
3a. des: the discrete-event simulator's four CUDA lanes (Lindley, free
   server, windowed masked argmin, impatience event pass) at the sizes of
   the repo's DES benchmarks: BENCH_disciplines.json's grid (3 policies x
   3 arrival rates x 16 seeds x 10,000 queries, window 512) through
   sweep_disciplines and sweep with backend="torch" (fifo, sjf,
   priority, spjf), BENCH_multiserver.json's four cells (c 2 / 4, rho
   0.6 / 0.9) through free_server_torch with the Lee-Longton gap checked
   as the bench does, and benchmarks/resilience_bench.py's retry lane
   (16 streams x 20,000 queries at rho 0.95, patience 2 and 200, both
   orphaned modes) through impatience_torch; each kernel's launches on
   that run, every kernel call of it recorded; then each kernel on
   exactly the inputs the main path gave it: bitwise equal to one plain
   pass on the card over all of them stacked along the streams (the four
   retry policies as 64 streams at full size; the nine windowed launches,
   48 streams each, with fifo's keys on the same streams), within 1e-9 of
   the NumPy lane after the heapq fallback, and the windowed lane within
   1e-10 of mg1.event_loop on 6 streams a discipline; times of kernel
   (summed over the main path's launches, and each launch), plain version
   (on the card) and NumPy lane (host), the bytes-or-fp64 bound and the
   sequential floor (the launches' dependent steps x one step's latency,
   measured); the rows print as the des_lanes line before the
   kernels' summary;
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
   reference prefill held in situ against the kernel, and the f32
   floor (the plain versions' path against the sequential oracle's);
   its end-to-end logits are held to 1.5 times that floor of the
   reference and sequential paths (RWKV_LOGIT_REASON), and an f64
   witness measures each f32 evaluation's prefill logits, and the plain
   chunked scan's in f64, against the reference path (the JAX model's
   chunked math) in f64. Then phase 6 in bf16 (the scan
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
   DecodeEngine, and its tokens equal. Then zamba2-7b-instruct (Zamba2
   as published) in bf16 at full width and depth through the paged
   continuous serve, launches counted from just before the stream: the
   SSD scan 2 x 81 times an admission group, flash 13 times a group,
   paged decode 13 times a replayed step, the FFN kernel never;
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
12b. the MoE ids, deepseek-moe-16b (64 routed experts top-6 and 2 shared)
   and granite-moe-3b-a800m (40 top-8): phase 4 in f32 (deepseek at
   DS_F32_LAYERS of its 28 layers, granite at full depth), the kernel
   path's run taking the reference path's expert choices at every layer
   and token, with the rows whose own top-k differed counted
   (ROUTING_REASON); phase 6 in bf16 at full width and depth (the FFN
   launched with per-expert rows, once for the routed and, on deepseek,
   once for the shared experts a layer, each prefill and replayed step,
   and the pair ranks' kernel once a layer each prefill and replayed
   step, counted exactly; one eager decode step under
   torch.cuda.set_sync_debug_mode("error"), so no op reads the host;
   the eager-vs-graph pin), and for deepseek the continuous serve on the
   slot and on the paged engine on the same weights (admissions one
   request a group under capacity dispatch; flash, decode and FFN
   launches exact); each model freed before the next; each sub-phase's
   seconds printed (moe_seconds);
13. qwen3-8b, the paper's model: phases 4 and 5 in f32 at full width and
   4 of its 36 layers (QWEN3_8B_F32_LAYERS: the f32 weights and the
   reference path's copies), then phase 6 in bf16 at full width and full
   depth, the server on the wall clock (ServerConfig(mode="wall"));
14. calibration: fit_latency to the qwen3-8b serve's per-request (tokens,
   seconds), fit_step_latency to phase 9's points; paper_problem solved
   again with the fitted t0 and c, its budgets printed beside the
   paper's, and the occupancy model at the fitted constants. These print
   numbers and gate nothing on speed. Then the integer step on the fitted
   problem: solve with integer_method exhaustive, coordinate and round,
   the eq-41 sandwich in tests/test_core_integer.py's order, and the
   deployed budgets through simulate_fifo_batch(backend="torch") (16
   seeds x 10,000 queries at lambda 0.1): the P-K mean system time must
   lie within the DES mean +- 3 x its 95% CI.
15. sweeps: repro_torch.sweeps.solve_grid on the card over
   tests/test_solver_grid.py's 100-cell grid (lambda 0.05-0.5 x alpha
   10-60 x l_max 1024 / 32768), its three PGA-fallback cells (lambda 1-3),
   a c-grid (c 1 / 2 / 4 x five lambdas up to 0.9 c lambda_sat) and a
   10,000-cell grid on the same axes: each solved cold and warm on the
   card and once on the host, and held to the host run (integer budgets,
   feasible, stable, used_pga and per-cell iteration counts equal,
   continuous optima within 1e-6, J(l*) within 1e-9). An Armijo cell may
   stop apart on the card and the host (its iteration count differs or
   its optimum moves by 1e-6 or more: rounding on the card's last bits
   can move an Armijo test, and the stopping test fixes l* on a flat
   objective only to about tol over its curvature); such cells are
   counted, held to J(l*) within 1e-9 and, at the grid's tol and
   re-solved on both at tol 1e-12, to twice the radius the stopping test
   allows around the optimum (tol over the least curvature of -J, plus
   what J's f64 rounding hides); reference_check measures them on both
   grids. reference_check on 12 cells of the 100-cell grid;
   then evaluate_solution(backend="torch") on its integer budgets (8
   seeds x 10,000 queries), one M/G/2 cell and one SJF cell, which launch
   des_lindley, des_free_server and des_windowed (their launches join the
   des_lanes rows as launches_sweeps): each bitwise equal to the lanes'
   plain versions and within 1e-9 of the NumPy backend. Times print,
   none is gated.
16. replay_engine (right after the calibration, on phase 13's qwen3-8b
   weights, one init for both): the closed loop's engine lane,
   ReplayHarness.run_engine through a fresh DecodeEngine (capacity
   2048, chunk 16) on 32 requests at lambda 0.5 with 8-token prompts,
   blocks of 8, l_max 128, l_init 64, half the budgets jittered; the
   re-solves on the card. Every decode's budget enforced, the waits
   obeying Lindley on the measured services, one capture across the
   budgets, flash, slot decode (once a layer a step) and the FFN
   launched, a re-solve run; the LatencyCalibrator's (t0_k, c_k) of the
   identified tasks printed beside phase 14's fit;
17. replay: the closed loop's virtual lane on tests/test_replay.py's
   convergence run (20,000 requests at lambda 0.1, blocks of 512), the
   controller's solve_grid once on the card and once on the host: the
   same budgets in every block, bitwise the same waits, more than 10
   re-solves, final budgets within 16 tokens of the oracle; each side's
   re-solve ms (median, p90) and wall time;
18. replay_drift: a lambda step (6,000 requests at 0.1, 6,000 at 0.3)
   in drift mode with an admission ladder, a tracer, a metrics registry
   and a straggler fault, re-solving on the card: the alarm fires after
   the step, the deployed budgets shrink, every completed request's span
   tree is whole; the drift history, ladder levels and sheds printed.
19. vlm_audio (after the MoE ids): llava-next-mistral-7b and
   musicgen-medium behind their stub frontends' prefixes (1152 image-patch
   and 64 conditioning-frame embeddings at d_model, 0.1 x normal from a
   seeded generator): phase 4 in f32 behind the prefix (llava at
   LLAVA_F32_LAYERS of its 32 layers, musicgen at full depth), then in
   bf16 at full width and depth the prefix generate (DecodeEngine, two
   37-token prompts behind a [2, P, d] prefix, the graph's capture call,
   a replay-only call and the eager loop: tokens equal, exact budgets,
   launches exact, decode tokens/s and ms a step against the weights'
   floor), phase 6's serve (text-only, as the JAX package's server), and
   for musicgen the slot and the paged continuous serves (phase 7's
   checks; its GELU MLP never launches the FFN); each sub-phase's
   seconds printed (vlm_audio_seconds);
20. train: repro_torch.launch.train.main on full-width olmo-1b in bf16
   (batch 8 x 64, 30 steps, lr 3e-3): every loss finite, the last 5
   steps' mean below the first 5's, no kernel launched (the trainer runs
   the reference math; no Pallas kernel of the JAX package has a VJP);
   median step ms, tokens/s, peak memory, model-FLOP share at 989
   TFLOP/s; reduced olmo-1b 4 steps, a checkpoint, a restore into a
   fresh state and 4 more against 8 uninterrupted (losses within 1e-6
   relative; bitwise or not, by default and under PyTorch's
   deterministic algorithms); a kernel given a CUDA input that requires
   grad raises.
21. distribution (after the replay engine, on its qwen3-8b weights):
   qwen3-8b's steps at the (16, 16) pod mesh's per-device share of
   launch/shapes.py's global shapes, at full width in bf16 through
   launch/steps.py on the kernels: prefill_32k (B 2, S 32,768; held
   against the reference path at the prompt's first 4,096 tokens, top-1
   equal; at full S finite only: plain attention there needs a 137 GB
   score tensor), decode_32k (B 8 over 32,768 slots filled from a seeded
   generator, 16 greedy steps) and long_500k (B 1, a ring of the 8,192
   window; 16 steps), each decode's first step held against the
   reference path on the same cache (top-1 equal, max |delta| within
   0.5). Each hold also runs the reference path on f32 weights (a
   decode's in 2-row caches of its own, their K/V drawn again from the
   cache's seed): the kernel path may lie at most 1.5x as far from it as
   the bf16 reference path. After qwen3-8b's weights are freed, the scan
   families' steps, held the same way: zamba2-7b prefill_32k and
   decode_32k, rwkv6-1.6b prefill_32k (full width and depth, their
   launches exact); there a row's kernel top-1 may be a token whose
   reference logit lies within 0.125 of the top one (tied by bf16
   rounding). Each step prints its median ms, launches, its roofline's compute_s,
   memory_s and bottleneck (roofline/analysis.py on the reference math
   at the same shapes, counted on the host), roofline_share (the larger
   term over the measured time), mfu (model FLOPs over the time at
   989.4 TFLOP/s) and the card. Then the sharded path on a 1x1 NCCL
   mesh: qwen3-0.6b in f32 at 4 of 28 layers, its parameters, tokens
   and cache DTensors; the train step's loss and gradient norm and a
   decode step's logits within 1e-5 of the unsharded reference path,
   the state's placements kept, no kernel launched.

Each top-level phase prints its seconds as it ends (phase_seconds), and
a summary of them precedes the des_lanes line. ``--only kernels,
vlm_audio,train,distribution,published_hybrid`` (any subset) runs just
those after the build: a development run that prints neither the
summary below nor the ok line.

The des_lanes line, the card's name and power limit, then, as the line
before the last, the kernels' JSON summary (with each kernel's
launches on every serve path that ran it, the int8 serve, the int8 paged
drain, the hooks serve, every continuous serve, the recurrent drains, the
window check, the replay engine lane, the prefix generates, the
VLM / audio serves and the six distribution steps among them);
the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import inspect
import json
import pathlib
import shutil
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
                "(the scans' reference is the JAX models' chunked math) and "
                "the difference compounds over the layers; 1e-3 is about "
                "0.1% of the logits' scale")
RWKV_FLOOR_FACTOR = 1.5
RWKV_LOGIT_REASON = (
    "1.5 x sequential_path_logits_max_abs_err, the floor measured in this "
    "run: two exact f32 evaluations of full-width rwkv6 with random "
    "weights whose arithmetic differs (the reference path on the "
    "sequential wkv oracle, and each scan's plain chunked version in place "
    "of its kernel) already differ far above 1e-3 after 24 layers; the "
    "reference path's chunked math rounds almost as the plain version "
    "does, so their distance (plain_path_logits_max_abs_err) is no floor. "
    "The kernel path is held within it of both the reference path and the "
    "sequential one. f64_witness holds every f32 evaluation's prefill "
    "logits against the reference path in f64 (the kernel path may sit at "
    "most 1.5 x as far from it as the f32 reference or plain path does) "
    "and the plain chunked scan in f64 against it within 1e-3; every scan "
    "is also held in situ at the scan tolerances, and greedy tokens must "
    "agree")
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
# zamba2-7b-instruct's (Zamba2 as published): its shared blocks' 32 heads
# of 224 (G 1) at the softmax scale (224 / 2)^-0.5, B/C in 2 groups of
# the 112 SSD heads, and its benchmark cell's 64 paged rows at the deep
# mix's contexts (prompts 16-128 plus budgets up to 1,617 and 8 answer
# tokens: positions 16 to 1,752)
ZI_H, ZI_HD, ZI_SCALE, ZI_GROUPS = 32, 224, 112 ** -0.5, 2
ZI_ROWS, ZI_POS = 64, (16, 1752)
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
# llava-next-mistral-7b's: 8 kv heads of 128 with 4 query heads each, d
# 4096 / d_ff 14336, 1152 prefix rows (2 anyres tiles of 576 patches), and
# the prefix generate's cache; musicgen-medium's 24 heads of 64 (G 1) and
# 64 conditioning rows
LL_H, LL_G, LL_D, LL_DFF, LL_P = 8, 4, 4096, 14336, 1152
MG_H, MG_HD, MG_P = 24, 64, 64
PREFIX_PROMPT = 37        # the prompt behind the prefix (as the f32 checks)
PREFIX_BUDGETS = (48, 30)  # the prefix generate's two rows, + 8 answer tokens
LL_C = LL_P + PREFIX_PROMPT + 64   # its cache: prefix + prompt + 56 tokens
LLAVA_F32_LAYERS = 4      # llava's f32 check (f32 weights at full depth: 29
                          # GB, and the reference path's copies beside them)
# the MoE ids: deepseek-moe-16b's 64 routed experts top-6 (d 2048, d_expert
# 1408) and 2 shared (one SwiGLU of 2816); granite-moe-3b-a800m's 40 top-8
# (d 1536, 512); a capacity prefill's buffer is C = int(S k 1.25 / E) rows
# an expert at the stream's longest prompt
DS_E, DS_K, DS_D, DS_F, DS_SHARED_F = 64, 6, 2048, 1408, 2816
GR_E, GR_K, GR_D, GR_F = 40, 8, 1536, 512
MOE_PREFILL_S = 113
DS_F32_LAYERS = 4         # deepseek's f32 check (full depth: ~68 GB in f32)
SCAN_GROUP_B, SCAN_GROUP_S = 4, 64  # a continuous admission group's scans
DRAIN_BUDGET = 12         # the recurrent drain's budget (no answer tokens)
PIN_BUDGET = 64           # budget cap of the eager-vs-graph pin's requests
EAGER_PROFILED_STEPS = 4  # eager decode steps under the profiler (its wall
                          # time a step comes from 16 unprofiled ones)
OCCUPANCIES = (1, 2, 4, 8)  # continuous engines timed for fit_step_latency
HOOKS_QUERIES = 48        # the hooks serve's stream, at 2x the service rate
# the closed loop (serving.replay): tests/test_replay.py's runs
REPLAY_QUERIES = 20_000       # test_closed_loop_converges_to_oracle's trace
REPLAY_BLOCK = 512
REPLAY_ORACLE_TOL = 16        # tokens, the reference test's tolerance
DRIFT_QUERIES = 6_000         # each side of the lambda step (x1, then x3)
DRIFT_BLOCK = 256
ENGINE_QUERIES = 32           # the engine lane on qwen3-8b
ENGINE_LAM = 0.5              # its trace's arrival rate (1/s)
ENGINE_L_MAX = 128
ENGINE_PROMPT = 8
# the distribution phase: qwen3-8b's steps at the pod mesh's (16 x 16)
# per-device share of launch/shapes.py's global shapes (the batch over the
# 16-wide data axis; long_500k's batch of 1 is replicated)
DIST_BATCH = {"prefill_32k": 2, "decode_32k": 8, "long_500k": 1}
DIST_HOLD_S = 4096        # the prefill's kernel-vs-reference hold (plain
                          # attention at S 32,768 needs a 137 GB score tensor)
DIST_STEPS = 16           # serve steps after the filled cache
DIST_S = 32768            # prefill_32k / decode_32k's sequence
DIST_WINDOW = 8192        # long_500k's ring (adapt_config's window)
DIST_FLASH_ROWS = 256     # query rows the S 32,768 flash case is held on
DIST_KERNEL_REPS = 5      # timed calls of the kernel cases at those shapes
DIST_PREFILL_RUNS = 2     # timed full prefills
DIST_SHARDED_LAYERS = 4   # qwen3-0.6b's 28 layers, cut for the 1x1 mesh
# the steps' logits, kernel path against reference path, bf16 at 36
# layers: max |delta| read 0.047 (prefill, 4,096 tokens), 0.19
# (decode_32k) and 0.16 (long_500k) on the H100; the limit is 2.5x the
# largest. A kernel at fault is caught by its kernel case at these shapes
# (each step's shapes have their cases: qwen3-8b's and zamba2-7b's flash,
# slot decode and FFN, the two scans)
DIST_HOLD_TOL = 0.5
# the scan families' steps (after qwen3-8b's, its weights freed): zamba2's
# long_500k is left out (its shared attention has no window: B 1 holds
# ~97.7 GB of KV), and rwkv6's decodes (they launch no hand kernel)
DIST_SCAN_STEPS = {"zamba2-7b": ("prefill_32k", "decode_32k"),
                   "rwkv6-1.6b": ("prefill_32k",)}
# their top-1 hold: random weights give flat logits (the largest |logit|
# near 3 over 32,000 tokens), so a row's first two logits may lie closer
# than bf16 rounding moves them. The bf16 reference path alone (no
# kernel) lies 0.252 (zamba2 prefill_32k) and 0.451 (rwkv6 prefill_32k)
# from the same path on f32 weights (max |delta| on the H100), so the
# kernel path may rank first a token whose reference logit lies within
# DIST_TIE_MARGIN of the reference's top one: half the smaller of those
# distances (8 bf16 ulps of a logit in [2, 4)). A fixed band: it does not
# widen as a kernel's error grows. Read: zamba2's decode_32k flipped two
# rows at reference margins 0.016 and 0.0 (f32 margins 0.021 and 0.015;
# on one of them the kernel path agrees with the f32 reference and the
# bf16 reference path does not), rwkv6's prefill_32k one at 0.078. Every
# other row must agree, and max |delta| stays held at DIST_HOLD_TOL;
# qwen3-8b's steps take no tie band
DIST_TIE_MARGIN = 0.125
DIST_TIE_REASON = (f"the kernel path may rank first a token whose "
                   f"reference logit lies within {DIST_TIE_MARGIN} of the "
                   "reference's top one (half the bf16 reference path's "
                   "smallest distance from its f32 counterpart): tied by "
                   "bf16 rounding")
# every step's hold also runs the reference path on f32 weights (the JAX
# models' math in f32 end to end, _witness): the kernel path may sit at
# most this many times as far from it as the bf16 reference path does.
# Both bf16 paths round the same weights and activations; the kernel's
# own sums (tiles, chunks, a split merge) add a share of rounding of
# their own beside that, while a kernel at fault (a lost tile, chunk or
# state) moves the logits by O(1). Read 1.15 (zamba2 prefill_32k) and
# 1.14 (rwkv6 prefill_32k) on the H100
DIST_WITNESS_FACTOR = 1.5
# rows of a decode step's f32 witness at a time: the whole decode_32k
# cache in f32 does not fit beside the weights (zamba2: 97.8 GB)
DIST_WITNESS_ROWS = 2
DIST_CACHE_SEED = 1       # the decode cache's draws, replayed by the witness
DIST_SHARDED_TOL = 1e-5   # sharded against unsharded reference path, f32
DIST_STATE_TOL = 5e-5     # the sharded step's m and v, of each leaf's norm
                          # (tests/test_torch_sharding.py's bar)


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
               fields=None, one_call=True, reps=25):
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
               **per_slot, **extra, "ok": ok,
               "ms": median_ms(fn, flush, reps),
               "plain_ms": median_ms(plain, flush, reps),
               "library_ms": None if lib is None else median_ms(lib, flush,
                                                                reps),
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

    def flash_case(dtype, S, H, G, HD, main, B=1, window=None, scale=None):
        qm = randn(B, S, H * G, HD, dtype=dtype)
        km = randn(B, S, H, HD, dtype=dtype)
        vm = randn(B, S, H, HD, dtype=dtype)
        q = qm.reshape(B, S, H, G, HD).permute(0, 2, 3, 1, 4)
        k, v = km.permute(0, 2, 1, 3), vm.permute(0, 2, 1, 3)
        fa = flash_attention.flash_attention
        plain = flash_attention.flash_attention_plain
        got = fa(q, k, v, window=window, scale=scale)
        want = plain(q, k, v, window=window, scale=scale)
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
        if scale is not None:
            case += f" scale={scale:.6g}"
        record("flash_attention", case, dtype,
               got, want, TOL[dtype], TOL_REASON[dtype],
               lambda: fa(q, k, v, window=window, scale=scale),
               lambda: plain(q, k, v, window=window, scale=scale),
               lambda: F.scaled_dot_product_attention(ql, kl, vl,
                                                      attn_mask=mask,
                                                      scale=scale),
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
    # the replay engine lane's prefill: qwen3-8b, one prompt of 8 tokens
    flash_case(torch.bfloat16, ENGINE_PROMPT, Q8_H, Q8_G, HD, main=False)
    # starcoder2-3b's prefill past its window (the window check's prompt),
    # and stablelm-3b's head width 80 at G = 1 (padded to 128 in the CTA)
    flash_case(torch.bfloat16, SC_S, SC_H, SC_G, HD, main=False,
               window=SC_WINDOW)
    flash_case(torch.bfloat16, max(prompt_lens), SL_H, 1, SL_HD, main=False)
    # the VLM and audio prefills: llava's 1152 image rows plus the prompt
    # (S 1189, G 4; B 2 is the prefix generate's), musicgen's 64 rows plus
    # the prompt (S 101, G 1, hd 64)
    for dtype in (torch.bfloat16, torch.float32):
        flash_case(dtype, LL_P + PREFIX_PROMPT, LL_H, LL_G, HD, main=False)
        flash_case(dtype, MG_P + PREFIX_PROMPT, MG_H, 1, MG_HD, main=False)
    flash_case(torch.bfloat16, LL_P + PREFIX_PROMPT, LL_H, LL_G, HD,
               main=False, B=2)
    # zamba2-7b-instruct's shared blocks at hd 224 (the tensor-core route
    # pads it to 256) and scale 112^-0.5: one admission's prompt, the
    # shortest, f32, and a group of 7 equal-length rows (the most one
    # admission prefill of the published hybrid batches at full size)
    for dtype, S, B in ((torch.bfloat16, max(prompt_lens), 1),
                        (torch.bfloat16, 16, 1), (torch.float32, 37, 1),
                        (torch.bfloat16, 128, 7)):
        flash_case(dtype, S, ZI_H, 1, ZI_HD, main=False, B=B,
                   scale=ZI_SCALE)

    # the distribution phase's prefill_32k on one card: qwen3-8b at B 2 x
    # S 32,768, G 4, and zamba2-7b's shared attention at G 1, hd 112. The
    # plain version over every pair would need a 137 GB
    # score tensor, so the kernel's output is held on DIST_FLASH_ROWS query
    # rows (the first 64, the last 64, the rest spread between) against
    # the plain arithmetic on those rows over all their keys
    def flash_rows_plain(q, k, v, rows):
        """``flash_attention_plain``'s arithmetic (f32 scores and sums,
        weights rounded to the input dtype) on the causal query rows
        ``rows`` of q [B, H, G, S, hd]."""
        hd = q.shape[-1]
        s = torch.einsum("bhgqd,bhkd->bhgqk", q[:, :, :, rows].float(),
                         k.float()) * (1.0 / hd ** 0.5)
        keep = torch.arange(k.shape[2], device=dev)[None] <= rows[:, None]
        s = torch.where(keep, s, torch.full_like(s, flash_attention.NEG_INF))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True)
        out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(),
                           v.float())
        return (out / l.clamp_min(1e-30)).to(q.dtype)

    def flash_rows_case(dtype, B, S, H, G, HD, n_rows):
        from torch.nn.attention import SDPBackend, sdpa_kernel
        qm = randn(B, S, H * G, HD, dtype=dtype)
        km = randn(B, S, H, HD, dtype=dtype)
        vm = randn(B, S, H, HD, dtype=dtype)
        q = qm.reshape(B, S, H, G, HD).permute(0, 2, 3, 1, 4)
        k, v = km.permute(0, 2, 1, 3), vm.permute(0, 2, 1, 3)
        rows = torch.cat([torch.arange(64),
                          torch.linspace(64, S - 65, n_rows - 128).long(),
                          torch.arange(S - 64, S)]).unique().to(dev)
        fa = flash_attention.flash_attention
        got = fa(q, k, v)[:, :, :, rows]
        want = flash_rows_plain(q, k, v, rows)
        ql = qm.transpose(1, 2)
        kl = k.repeat_interleave(G, dim=1)
        vl = v.repeat_interleave(G, dim=1)

        def library():
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                return F.scaled_dot_product_attention(ql, kl, vl,
                                                      is_causal=True)
        el = qm.element_size()
        nbytes = B * (2 * H * G + 2 * H) * S * HD * el
        flops = B * H * G * (S * (S + 1) // 2) * 4 * HD
        record("flash_attention",
               f"B={B} S={S} H={H} G={G} hd={HD} (held on {len(rows)} "
               f"query rows incl. the last; plain_ms is those rows')",
               dtype, got, want, TOL[dtype], TOL_REASON[dtype],
               lambda: fa(q, k, v), lambda: flash_rows_plain(q, k, v, rows),
               library, nbytes, flops, main=False,
               library="scaled_dot_product_attention (flash backend, "
                       "is_causal, kv repeated to the query heads)",
               fields={**flash_fields(B, S, H, G, HD, dtype),
                       "plain_rows": len(rows)}, reps=DIST_KERNEL_REPS)
        del qm, km, vm, q, k, v, kl, vl, got, want

    for h, g, hd in ((Q8_H, Q8_G, HD), (Z_H, 1, Z_HD)):
        flash_rows_case(torch.bfloat16, DIST_BATCH["prefill_32k"], DIST_S,
                        h, g, hd, DIST_FLASH_ROWS)

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
                    what=None, dominant=None, C=C, reps=25):
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
               fields=split_fields(B, H, C, HD, dtype), reps=reps)

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
        # llava over its prefix (the prefix generate's two rows) and
        # musicgen at G 1, hd 64: batch 1 and 8 continuous slots
        decode_case(dtype, 2, (LL_P + PREFIX_PROMPT + 1, LL_C - 8), LL_H,
                    LL_G, HD, main=False, C=LL_C)
        decode_case(dtype, 1, (MG_P + PREFIX_PROMPT + 1,), MG_H, 1, MG_HD,
                    main=False)
        decode_case(dtype, 8, tuple(p + 1 for p in POS), MG_H, 1, MG_HD,
                    main=False)
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

    # the distribution phase's decodes on one card: decode_32k's 8 rows
    # over a 32,768-slot cache with 32,753 valid (its first serve step's),
    # then with one dominant slot in the last split's last tile, at
    # qwen3-8b's G 4 and at zamba2-7b's shared attention (32 heads, G 1,
    # hd 112: another split plan); long_500k's ring of 8,192 (qwen3-8b),
    # full, and wrapped past slot 0
    bf16, n32 = torch.bfloat16, DIST_S - DIST_STEPS + 1
    valid32 = (torch.arange(DIST_S, device=dev)[None] < n32).expand(
        DIST_BATCH["decode_32k"], DIST_S).contiguous()
    for h, g, hd in ((Q8_H, Q8_G, HD), (Z_H, 1, Z_HD)):
        plan = decode_attention.split_plan(DIST_BATCH["decode_32k"], h,
                                           DIST_S, hd, bf16,
                                           _cuda.sm_count(0))
        last = min(plan.tiles(plan.n_split - 1)[-1] * plan.tile + 5, n32 - 1)
        for dominant in (None, last):
            decode_case(bf16, DIST_BATCH["decode_32k"], None, h, g, hd,
                        False, mask=valid32, C=DIST_S, dominant=dominant,
                        what=f"valid=[{n32}] x {DIST_BATCH['decode_32k']}"
                             + ("" if dominant is None else
                                f" dominant slot {dominant} (last split)"),
                        reps=DIST_KERNEL_REPS)
    ring = torch.ones(1, DIST_WINDOW, dtype=torch.bool, device=dev)
    decode_case(bf16, 1, None, Q8_H, Q8_G, HD, False, mask=ring,
                what=f"valid=all {DIST_WINDOW} (a wrapped ring)",
                C=DIST_WINDOW, reps=DIST_KERNEL_REPS)
    ring = ring.clone()
    ring[0, 200:DIST_WINDOW - 300] = False
    decode_case(bf16, 1, None, Q8_H, Q8_G, HD, False, mask=ring,
                what=f"valid={DIST_WINDOW - 300}..{DIST_WINDOW - 1}, 0..199 "
                     "(a ring wrapping past slot 0)", C=DIST_WINDOW,
                reps=DIST_KERNEL_REPS)

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

    def paged_case(dtype, pos_list, main, holes=(), retired=None, G=G, H=H,
                   HD=HD, scale=None, P=P):
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
        got = pda(q, kp, vp, tables, pos, scale=scale)
        want = pda_plain(q, kp, vp, tables, pos, scale)
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
                                                  enable_gqa=True,
                                                  scale=scale)
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
        if scale is not None:
            what += f" scale={scale:.6g}"
        record("paged_decode_attention",
               f"B={B} P={P} bs={bs} n_bt={n_bt} {what} H={H} G={G} "
               f"hd={HD}", dtype, got, want, tol, reason,
               lambda: pda(q, kp, vp, tables, pos, scale=scale),
               lambda: pda_plain(q, kp, vp, tables, pos, scale), library,
               nbytes, flops, main=main,
               library="two calls: the k/v gather through the block table "
                       "(index) and scaled_dot_product_attention",
               fields=split_fields(B, H, n_bt * bs, HD, dtype, bs=bs))

    for dtype in (torch.bfloat16, torch.float32):
        paged_case(dtype, POS, main=(dtype == torch.bfloat16))
        paged_case(dtype, POS[:6] + (2000, 1500), main=False,
                   holes=((3, 2), (6, 5), (6, 64)), retired=7)
        paged_case(dtype, POS, main=False, G=Q8_G)          # qwen3-8b's
        paged_case(dtype, POS, main=False, G=1, H=MG_H, HD=MG_HD)  # musicgen
        # zamba2-7b-instruct's applications at hd 224 and scale 112^-0.5:
        # the 8 ragged slots, and its cell's 64 rows spread over the deep
        # mix's contexts on a pool of half their full tables (they take
        # 3,580 of its 4,096 blocks)
        zi = dict(main=False, G=1, H=ZI_H, HD=ZI_HD, scale=ZI_SCALE)
        paged_case(dtype, POS, **zi)
        paged_case(dtype, tuple(np.linspace(*ZI_POS, ZI_ROWS).astype(int)
                                .tolist()), P=ZI_ROWS * n_bt // 2, **zi)

    # -- 4. fused SwiGLU FFN, E = 1: T = 1 at batch-1 decode, 8 at the
    # continuous engine's 8 slots, S at prefill, and the largest padded
    # admission group of the drains (group size x longest prompt)
    def ffn_fields(T, D, DFF, dtype, E=1):
        plan = fused_ffn.ffn_plan(E, T, D, DFF, dtype, _cuda.sm_count(0))
        out = {"route": plan.route, "regime": plan.regime}
        if plan.route == "tensor_core":
            out.update(bm=plan.bm, ks_up=plan.ks_up, ks_down=plan.ks_down,
                       ctas_up=plan.grid_up, ctas_down=plan.grid_down,
                       scratch_bytes=plan.scratch_bytes)
        else:
            out.update(bt=plan.bt, n_split=plan.n_split)
        return out

    def ffn_case(dtype, T, D, DFF, main, reps=25):
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
               fields=ffn_fields(T, D, DFF, dtype), reps=reps)

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
    for T in (1, 8, MOE_PREFILL_S):                      # deepseek's shared
        ffn_case(torch.bfloat16, T, DS_D, DS_SHARED_F, main=False)
    # llava's: decode at batch 1 and 2, its prefix prefill at B 1 and 2
    for T in (1, 2, LL_P + PREFIX_PROMPT, 2 * (LL_P + PREFIX_PROMPT)):
        ffn_case(torch.bfloat16, T, LL_D, LL_DFF, main=False)
    ffn_case(torch.float32, 1, LL_D, LL_DFF, main=False)
    # the distribution phase's prefill_32k on one card: qwen3-8b's FFN and
    # zamba2-7b's shared MLP over B 2 x S 32,768 rows (their h scratch 1.6
    # and 1.88 GB)
    for d, dff in ((Q8_D, Q8_DFF), (Z_D, Z_DFF)):
        ffn_case(torch.bfloat16, DIST_BATCH["prefill_32k"] * DIST_S, d, dff,
                 main=False, reps=DIST_KERNEL_REPS)

    # -- 4b. the MoE's expert buffers [E, C, d] with per-expert live rows
    # (rows[e]): dropless decode (C = T, batch 1 and the continuous
    # engine's 8 slots) and a capacity prefill of the longest prompt, each
    # token routed to k distinct experts drawn at random; with rows (the
    # kernel skips the tiles past rows[e], so the experts no token hit)
    # and without (every expert and row computed). Held on the live rows.
    route_gen = torch.Generator().manual_seed(1)

    def moe_rows(E, k, T, C):
        counts = torch.zeros(E, dtype=torch.int32)
        for _ in range(T):
            counts[torch.randperm(E, generator=route_gen)[:k]] += 1
        return counts.clamp(max=C).to(dev)

    def moe_ffn_case(dtype, E, k, T, D, DFF, with_rows):
        C = T if T <= 8 else max(1, int(T * k * 1.25 / E))
        rows = moe_rows(E, k, T, C)
        x = randn(E, C, D, dtype=dtype)
        wg = randn(E, D, DFF, dtype=dtype, scale=D ** -0.5)
        wu = randn(E, D, DFF, dtype=dtype, scale=D ** -0.5)
        wd = randn(E, DFF, D, dtype=dtype, scale=DFF ** -0.5)
        r = rows if with_rows else None
        ff, plain = fused_ffn.fused_ffn, fused_ffn.fused_ffn_plain
        got = ff(x, wg, wu, wd, rows=r)
        want = plain(x, wg, wu, wd)
        live = (torch.arange(C, device=dev)[None] < rows[:, None]
                if with_rows else torch.ones(E, C, dtype=torch.bool,
                                             device=dev))
        hit = int((rows > 0).sum()) if with_rows else E
        n_live = int(rows.sum()) if with_rows else E * C
        tol, reason = ((FFN_F32_TOL, FFN_F32_REASON)
                       if dtype == torch.float32
                       else (TOL[dtype], TOL_REASON[dtype]))
        el = x.element_size()
        # the live rows in and out, the hit experts' weights once each
        nbytes = (2 * n_live * D + 3 * hit * D * DFF) * el
        flops = 6 * n_live * D * DFF

        def chain():
            return torch.bmm(F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu),
                             wd)
        what = (f"rows: {n_live} live, {hit} of {E} experts hit"
                if with_rows else "no rows: every expert and row")
        record("fused_ffn", f"E={E} C={C} d={D} d_ff={DFF} (T={T} top-{k}; "
               f"{what})", dtype, got[live], want[live], tol, reason,
               lambda: ff(x, wg, wu, wd, rows=r),
               lambda: plain(x, wg, wu, wd), chain, nbytes, flops,
               main=False, one_call=False,
               library="chain of 5 calls: torch.bmm x Wg, x Wu, silu, the "
                       "product, bmm Wd (every expert and row)",
               fields={**ffn_fields(C, D, DFF, dtype, E=E),
                       "experts_hit": hit, "live_rows": n_live,
                       "rows": None if r is None else r.tolist()})

    for widths in ((DS_E, DS_K, DS_D, DS_F), (GR_E, GR_K, GR_D, GR_F)):
        for T in (1, 8, MOE_PREFILL_S):
            for with_rows in (True, False):
                moe_ffn_case(torch.bfloat16, *widths[:2], T, *widths[2:],
                             with_rows)
        moe_ffn_case(torch.float32, *widths[:2], 1, *widths[2:], True)

    # -- 5. the scans at the recurrent prefills' shapes (B = 1), and at a
    # continuous admission group's (B = 4 equal-length prompts), in the
    # models' layouts: [B, S, H, ...] viewed as [B, H, S, ...]
    sms = _cuda.sm_count(0)

    def scan_cases(dtype, B, S, main, reps=25):
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
               nbytes, flops, main=main, state=(gs, ws), reps=reps,
               fields=rwkv6_scan.rwkv6_plan(B, RWKV_H, S, RWKV_HD, dtype,
                                            sms).fields())
        del r, k, v, la, u, got, gs, want, ws
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
               nbytes, flops, main=main, state=(gs, ws), reps=reps,
               fields=ssd_scan.ssd_plan(B, SSD_H, S, SSD_HD, SSD_DS,
                                        dtype, sms).fields())

    for dtype in (torch.bfloat16, torch.float32):
        for S in SCAN_S:
            scan_cases(dtype, 1, S, main=dtype == torch.bfloat16 and S == 113)
        scan_cases(dtype, SCAN_GROUP_B, SCAN_GROUP_S, main=False)
    # at the scan families' prefill_32k steps (the distribution phase):
    # B 2 x S 32,768, the state carried over 512 of the kernels' chunks
    scan_cases(torch.bfloat16, DIST_BATCH["prefill_32k"], DIST_S,
               main=False, reps=DIST_KERNEL_REPS)

    # zamba2-7b-instruct's grouped B/C: heads 0-55 read group 0's rows and
    # 56-111 group 1's; the model launches the scan once a group over its
    # heads' slice (mamba2._per_group), held here against the plain
    # version over all 112 heads on B/C repeated per head
    def grouped_ssd_case(dtype, B, S):
        from repro_torch.kernels import LAUNCHES
        from repro_torch.kernels import ops as kops
        from repro_torch.models import mamba2
        g = ZI_GROUPS
        x = randn(B, S, SSD_H, SSD_HD, dtype=dtype)
        dt = F.softplus(randn(B, S, SSD_H, dtype=torch.float32) - 2.0)
        la = -dt
        bm, cm = (randn(B, S, g * SSD_DS, dtype=dtype) for _ in range(2))
        per_head = [t.unflatten(-1, (g, -1))
                    .repeat_interleave(SSD_H // g, dim=2)
                    .permute(0, 2, 1, 3) for t in (bm, cm)]
        xh = x.permute(0, 2, 1, 3)
        dth, lah = dt.permute(0, 2, 1), la.permute(0, 2, 1)

        def run():
            return mamba2._per_group(kops.ssd_scan, g, x, dt, la, bm, cm)

        def plain():
            return ssd_scan.ssd_scan_plain(xh, dth, lah, *per_head)
        n0 = LAUNCHES["ssd_scan"]
        got, gs = run()
        check(LAUNCHES["ssd_scan"] - n0 == g,
              f"grouped ssd_scan: {LAUNCHES['ssd_scan'] - n0} launches for "
              f"{g} groups")
        want, ws = plain()
        el = x.element_size()
        nbytes = B * (SSD_H * (2 * S * SSD_HD * el + 2 * S * 4
                               + SSD_HD * SSD_DS * 4)
                      + 2 * g * S * SSD_DS * el)
        flops = 5 * B * SSD_H * S * SSD_HD * SSD_DS
        record("ssd_scan", f"B={B} H={SSD_H} S={S} hd={SSD_HD} "
               f"ds={SSD_DS} groups={g} (a launch a group of {SSD_H // g} "
               "heads)", dtype, got.permute(0, 2, 1, 3), want,
               scan_tol("ssd_scan", dtype, want), SCAN_REASON[dtype],
               run, plain, None, nbytes, flops, main=False,
               state=(gs, ws),
               fields={**ssd_scan.ssd_plan(B, SSD_H // g, S, SSD_HD,
                                           SSD_DS, dtype, sms).fields(),
                       "launches": g})

    for dtype, B, S in ((torch.bfloat16, 1, max(prompt_lens)),
                        (torch.bfloat16, 1, 16), (torch.float32, 1, 37),
                        (torch.bfloat16, 7, 128)):
        grouped_ssd_case(dtype, B, S)
    ranks_rows, summary["moe_ranks"] = moe_ranks_cases(dev, flush)
    rows += ranks_rows
    return rows, summary


#: (E, top-k, T) of the pair ranks' rows: a 64-row decode step, a 512- and
#: a 2,500-token prompt of deepseek-moe-16b, a 64-row step of granite
MOE_RANKS_SHAPES = ((DS_E, DS_K, 64), (DS_E, DS_K, 512), (DS_E, DS_K, 2500),
                    (GR_E, GR_K, 64))


def moe_ranks_cases(dev, flush) -> tuple:
    """The pair ranks' kernel against its plain version (the one-hot's int64
    cumulative count, which the dispatch ran before the kernel), each
    token routed to k distinct experts at random: ranks alone, with a
    capacity's buffer rows (``C = int(T k 1.25 / E)``, the prefill's) and
    at ``C = T`` (decode's dropless buffer). Bit-equal, or the run fails.
    The bound: the experts read and the ranks (and rows) written once, at
    HBM speed. Returns (rows, the summary's row: deepseek's decode step,
    E 64 top-6 over 64 rows at C 64, the call of every MoE layer a
    step)."""
    from repro_torch.kernels import moe_ranks

    gen = torch.Generator().manual_seed(2)
    rows, main = [], None
    for E, k, T in MOE_RANKS_SHAPES:
        idx = torch.stack([torch.randperm(E, generator=gen)[:k]
                           for _ in range(T)]).to(dev)
        n = T * k
        for C in (0, max(1, int(T * k * 1.25 / E)), T):
            got = moe_ranks.moe_ranks(idx, E, C)
            want = moe_ranks.moe_ranks_plain(idx, E, C)
            err = max((a - b).abs().max().item() for a, b in zip(got, want)
                      if b is not None)
            nbytes = 8 * n * (2 + (2 if C else 0)) + 4 * E
            row = {"name": "moe_ranks",
                   "case": f"E={E} top-{k} T={T}: {n} pairs"
                           + (f", rows at C={C}" if C else ", ranks alone"),
                   "dtype": "int64", "max_abs_err": float(err),
                   "equal": err == 0,
                   "ms": median_ms(lambda: moe_ranks.moe_ranks(idx, E, C),
                                   flush),
                   "plain_ms": median_ms(
                       lambda: moe_ranks.moe_ranks_plain(idx, E, C), flush),
                   "library_ms": None, "library_one_call": False,
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "bound_by": "bytes"}
            print(json.dumps(row))
            rows.append(row)
            check(err == 0, f"moe_ranks {row['case']}: not equal to the "
                            f"plain version (max diff {err})")
            if (E, k, T, C) == (DS_E, DS_K, 64, 64):
                main = row
    return rows, main


def _greedy_run(cfg, params, prompt, force_ref, teacher=None,
                capacity: int = 64, steps: int = 8, prefix=None):
    """Prefill into a cache of ``capacity`` (plus the ``prefix`` rows'
    count) plus ``steps`` decode steps; returns (logits per step, greedy
    tokens). With ``teacher`` (a token list) the steps are fed those tokens
    instead of their own argmax. ``prefix``: the VLM / audio stub's
    embeddings [1, P, d] in front of the prompt."""
    from repro_torch.models import decode_step, forward

    if prefix is not None:
        capacity += prefix.shape[1]
    out = forward(cfg, params, prompt, prefix_embeds=prefix,
                  return_cache=True, cache_capacity=capacity,
                  force_ref=force_ref)
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
    """Every scan of the reference path's prefill (the JAX model's chunked
    math), held against the kernel on the very same activations at the
    scan tolerances: the kernel's error in the model, free of what the
    model's layers make of it."""
    from repro_torch.kernels import ops
    from repro_torch.models import forward, mamba2, rwkv6

    name = "rwkv6_scan" if cfg.backbone_kind == "rwkv6" else "ssd_scan"
    module, attr = (rwkv6, "wkv_chunked") if name == "rwkv6_scan" \
        else (mamba2, "ssd_chunked")
    chunked, kernel = getattr(module, attr), getattr(ops, name)
    rows = []

    def both(*args, **kw):
        want = chunked(*args, **kw)
        got = kernel(*args[:5])
        ey, oky = compare(got[0], want[0], *scan_tol(name, torch.float32,
                                                     want[0]))
        es, oks = compare(got[1], want[1], STATE_TOL, STATE_TOL)
        rows.append((ey, float(want[0].abs().max()), es, oky and oks))
        return want
    setattr(module, attr, both)
    try:
        forward(cfg, params, prompt, force_ref=True)
    finally:
        setattr(module, attr, chunked)
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
    [1, S, V]) against the reference path (the JAX model's chunked math,
    itself within f64 rounding of the sequential oracle) run in f64, and
    the kernel's chunked plain version run in f64 against the same:
    whether the f32 evaluations part by rounding or by the scan's form.
    RWKV6 only (its model computes in f64 when fed f64 weights); the
    kernel takes no f64, so its f32 path stands for it."""
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


def stub_prefix(dev, cfg, batch: int, dtype=None, seed: int = 0):
    """The VLM / audio stub frontend's output: ``[batch, n_prefix_embeds,
    d_model]`` at 0.1 x normal (tests/test_configs_smoke.py's scale), from
    a seeded generator on the card; None for a text model."""
    if not cfg.n_prefix_embeds:
        return None
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (0.1 * torch.randn(batch, cfg.n_prefix_embeds, cfg.d_model,
                              generator=gen, device=dev)
            ).to(dtype or cfg.tdtype)


def model_phase(dev, cfg, params) -> dict:
    """A full-width f32 model: the kernel path against force_ref, prefill
    (behind the stub's prefix rows for the VLM and audio ids) plus 8
    decode steps teacher-forced on the reference's greedy tokens; the
    kernel path's launches counted. For a scan family, also every
    scan in situ (scan_in_situ) and the f32 floor: the same comparison
    with each scan's plain version in place of its kernel, i.e. two exact
    f32 evaluations in other summation orders."""
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    from repro_torch.models import rwkv6

    prompt = torch.as_tensor(np.arange(37) % 97 + 1, device=dev)[None]
    prefix = stub_prefix(dev, cfg, 1)
    moe_family = cfg.backbone_kind == "moe"
    routes, pinned = [], {"rows": 0, "flips": 0, "max_flip_gap": 0.0}
    with (_routing(record=routes) if moe_family
          else contextlib.nullcontext()):
        ref, toks = _greedy_run(cfg, params, prompt, True, prefix=prefix)
    reset_launches()
    with (_routing(pin=routes, stats=pinned) if moe_family
          else contextlib.nullcontext()):
        ker, ker_toks = _greedy_run(cfg, params, prompt, False, teacher=toks,
                                    prefix=prefix)
    launches = dict(LAUNCHES)
    err = _max_err(ref, ker)
    agree = all(torch.equal(a[:, -1:].argmax(-1), b[:, -1:].argmax(-1))
                for a, b in zip(ref, ker))
    out = {"phase": "model", "arch": cfg.arch_id, "n_layers": cfg.n_layers,
           "dtype": "float32",
           "prompt_len": 37, "decode_steps": 8,
           "prefix_rows": 0 if prefix is None else prefix.shape[1],
           "logits_max_abs_err": err,
           "logits_max_abs": max(   # padded vocab columns hold -1e30
               float(x[..., :cfg.vocab_size].abs().max()) for x in ref),
           "tol": LOGIT_TOL, "tol_reason": LOGIT_REASON,
           "greedy_tokens_agree": agree, "launches": launches}
    if moe_family:
        out["routing"] = {**pinned, "why": ROUTING_REASON}
        out["fused_ffn_expected"] = moe_ffn_per_layer(cfg) * cfg.n_layers * 9
    scan_family = not cfg.has_attn_layers
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
        # the reference path on the sequential wkv oracle: an exact f32
        # evaluation whose arithmetic differs from both chunked ones
        chunked = rwkv6.wkv_chunked
        rwkv6.wkv_chunked = lambda *a: ops.rwkv6_scan(*a, force_ref=True)
        try:
            seq, _ = _greedy_run(cfg, params, prompt, True, teacher=toks)
        finally:
            rwkv6.wkv_chunked = chunked
        out["sequential_path_logits_max_abs_err"] = _max_err(seq, plain)
        out["sequential_vs_kernel_logits_max_abs_err"] = _max_err(seq, ker)
        out["tol"] = RWKV_FLOOR_FACTOR * \
            out["sequential_path_logits_max_abs_err"]
        out["tol_reason"] = RWKV_LOGIT_REASON
        w = out["f64_witness"] = f64_witness(
            cfg, params, prompt,
            {"reference": ref[0], "kernel": ker[0], "plain": plain[0]})
    print(json.dumps(out))
    check(agree, f"{cfg.arch_id} model: greedy tokens differ")
    if cfg.has_attn_layers:
        check_dense_launches(cfg, launches, f"{cfg.arch_id} model")
    if moe_family:
        check(pinned["max_flip_gap"] <= ROUTING_GAP_TOL,
              f"{cfg.arch_id} model: a top-k choice flipped at a gap of "
              f"{pinned['max_flip_gap']} > {ROUTING_GAP_TOL}")
        check(pinned["flips"] <= ROUTING_FLIP_SHARE * pinned["rows"],
              f"{cfg.arch_id} model: {pinned['flips']} of "
              f"{pinned['rows']} rows flipped a top-k choice")
        check(launches.get("fused_ffn", 0) == out["fused_ffn_expected"],
              f"{cfg.arch_id} model: fused_ffn launched "
              f"{launches.get('fused_ffn', 0)} times, expected "
              f"{out['fused_ffn_expected']} (prefill and 8 steps)")
    if scan_family:
        check(out["scan_in_situ"]["ok"],
              f"{cfg.arch_id} model: a scan in situ is out of tolerance "
              f"{out['scan_in_situ']}")
    check(err <= out["tol"],
          f"{cfg.arch_id} model logits err {err} > {out['tol']}")
    if cfg.backbone_kind == "rwkv6":
        check(out["sequential_vs_kernel_logits_max_abs_err"] <= out["tol"],
              f"{cfg.arch_id} model: the kernel path's logits are "
              f"{out['sequential_vs_kernel_logits_max_abs_err']} from the "
              f"sequential path's, over {out['tol']}")
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


ROUTING_REASON = (
    "the kernel path's run takes, at every MoE layer and token, the experts "
    "the reference path chose (its weights renormalised from its own "
    "probabilities): f32 rounding in other orders can flip a top-k choice "
    "between two near-equal router probabilities, and one flipped expert "
    "moves that token's residual by a whole expert's output. flips counts "
    "the rows whose own choice (set or order) differed; max_flip_gap is the "
    "largest, over those rows, of the smallest gap between neighbours among "
    "the top k + 1 probabilities. The pin hides only near-ties: the check "
    "fails at a flip whose gap exceeds ROUTING_GAP_TOL (1e-5; the largest "
    "seen was 4.5e-8, granite-moe-3b-a800m, NVIDIA H100 80GB HBM3) or at "
    "flips on more than ROUTING_FLIP_SHARE (1%) of the rows (1 in 1440 "
    "seen), either of which says the kernel path's hidden state moved "
    "enough to change a clear choice")
ROUTING_GAP_TOL = 1e-5
ROUTING_FLIP_SHARE = 0.01


@contextlib.contextmanager
def _routing(record=None, pin=None, stats=None):
    """``models.moe._route`` patched: ``record`` gets each call's experts;
    with ``pin`` each call takes the experts of the same call there, and
    ``stats`` counts the rows whose own choice differed (ROUTING_REASON)."""
    from repro_torch.models import moe

    orig = moe._route
    calls = iter(pin or ())

    def route(cfg, p, x2d):
        w, idx, probs = orig(cfg, p, x2d)
        if record is not None:
            record.append(idx.clone())
            return w, idx, probs
        want = next(calls)
        stats["rows"] += idx.shape[0]
        flip = (idx != want).any(-1)
        n = int(flip.sum())
        if n:
            top = torch.topk(probs, cfg.moe.top_k + 1, -1).values
            gap = (top[:, :-1] - top[:, 1:]).min(-1).values[flip]
            stats["flips"] += n
            stats["max_flip_gap"] = max(stats["max_flip_gap"],
                                        float(gap.max()))
            pw = probs.gather(1, want)
            w = (pw / pw.sum(-1, keepdim=True).clamp(min=1e-9)).to(w.dtype)
        return w, want, probs
    moe._route = route
    try:
        yield
    finally:
        moe._route = orig


def moe_ffn_per_layer(cfg) -> int:
    """FFN launches of a MoE layer a forward or a decode step: the routed
    experts' one, and the shared experts' one where there are any."""
    return 1 + bool(cfg.moe.n_shared_experts)


def check_step_reads_no_host(engine) -> None:
    """One decode step over the engine's static buffers, run eagerly under
    ``torch.cuda.set_sync_debug_mode("error")``: an op that reads the host
    raises (and would have failed the step's capture)."""
    logits, cache = engine.prefill(np.arange(24, dtype=np.int32)[None] % 97
                                   + 1)
    big = np.array([10 ** 6], np.int32)
    _, _, step = engine._prepare(logits.argmax(-1), cache, big, big, None,
                                 engine.chunk)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


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
    if cfg.has_attn_layers:
        return {"decode_attention": cfg.n_layers * steps}
    return {}


def serve_phase(dev, arch: str, kernels: tuple, mode: str = "virtual",
                n_layers=None, kv_cache_dtype: str = "model",
                params=None) -> dict:
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
    full-precision cache's and the dequantise's device time a step.
    ``params``: weights already on the card (seed 0) to serve with, in
    place of a fresh init."""
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
    marks = [("start", time.perf_counter())]
    if params is None:
        params = init_params(cfg, seed=0, device=dev)
    params_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    engine = DecodeEngine(cfg, params, cache_capacity=2048, chunk=16)
    graph_hooks.reset()
    engine.generate(np.ones((1, 16), np.int32), [4], max_extra_tokens=0)
    warm_captures = graph_hooks.capture_counts().get("engine.chunk", 0)
    marks.append(("warm", time.perf_counter()))
    timers = {"prefill_s": 0.0, "generate_s": 0.0, "prefills": 0}
    prefill, generate = engine.prefill, engine.generate

    def timed_prefill(*args, **kwargs):
        t0 = time.perf_counter()
        out = prefill(*args, **kwargs)
        torch.cuda.synchronize()
        timers["prefill_s"] += time.perf_counter() - t0
        timers["prefills"] += 1
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
    marks.append(("setup", time.perf_counter()))
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
    if cfg.backbone_kind == "moe":
        # routed (+ shared) a layer, each prefill and replayed step
        out["fused_ffn_expected"] = moe_ffn_per_layer(cfg) * cfg.n_layers \
            * (graph["steps"] + timers["prefills"])
        # the pair ranks: one a layer, each prefill and replayed step
        out["moe_ranks_expected"] = cfg.n_layers * (graph["steps"]
                                                    + timers["prefills"])
    print(json.dumps(out))
    for name in kernels:
        check(launches.get(name, 0) > 0,
              f"{name} was launched 0 times on the {arch} main path")
    if cfg.has_attn_layers:
        check_dense_launches(cfg, launches, f"{arch} serve")
    if cfg.backbone_kind == "moe":
        check(launches.get("fused_ffn", 0) == out["fused_ffn_expected"],
              f"{arch} serve: fused_ffn launched "
              f"{launches.get('fused_ffn', 0)} times, expected "
              f"{out['fused_ffn_expected']}")
        check(launches.get("moe_ranks", 0) == out["moe_ranks_expected"],
              f"{arch} serve: moe_ranks launched "
              f"{launches.get('moe_ranks', 0)} times, expected "
              f"{out['moe_ranks_expected']}")
    check(graph["captures"] == 1 and graph["host_reads_per_chunk"] == 1,
          f"{arch} serve: decode graph {graph}")
    for name, n in decode_launches_expected(cfg, graph["steps"]).items():
        check(launches.get(name, 0) == n,
              f"{arch} serve: {name} launched {launches.get(name, 0)} "
              f"times in {graph['steps']} replayed steps, expected {n}")
    engine.prefill, engine.generate = prefill, generate
    marks.append(("run", time.perf_counter()))
    if cfg.kv_cache_dtype == "int8":
        out["kv_cache"] = int8_cache_cost(engine)
    if cfg.backbone_kind == "moe":
        check_step_reads_no_host(engine)
    marks.append(("checks", time.perf_counter()))
    out["pin"] = eager_graph_pin(engine, stream, srv.completed)
    marks.append(("pin", time.perf_counter()))
    print(json.dumps({**decode_step_breakdown(engine), "arch": arch,
                      "kv_cache_dtype": cfg.kv_cache_dtype}))
    marks.append(("breakdown", time.perf_counter()))
    print(json.dumps({"phase": "serve_seconds", "arch": arch,
                      "kv_cache_dtype": cfg.kv_cache_dtype,
                      **{name: t - marks[i][1]
                         for i, (name, t) in enumerate(marks[1:])}}))
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
    t0 = time.perf_counter()
    out = {"phase": "decode_step_breakdown",
           "eager": profile_steps(eager, steps, steps,
                                  profiled_calls=EAGER_PROFILED_STEPS)}
    out["eager_s"] = time.perf_counter() - t0
    logits, cache = engine.prefill(prompt)
    big = np.array([10 ** 6], np.int32)
    key, _, step = engine._prepare(logits.argmax(-1), cache, big, big, None,
                                   engine.chunk)

    def replay():
        engine._graphs.run(key, step)
    for _ in range(4):
        replay()
    t0 = time.perf_counter()
    out["graph"] = profile_steps(replay, steps, steps)
    out["graph_s"] = time.perf_counter() - t0
    out["wall_speedup"] = (out["eager"]["wall_ms_per_step"]
                           / out["graph"]["wall_ms_per_step"])
    return out


def profile_steps(run, n_calls: int, steps: int,
                  profiled_calls: int | None = None) -> dict:
    """Host wall time per decode step of ``run`` (called ``n_calls`` times,
    ``steps`` decode steps in all, synchronised) against the device time
    of the kernels the profiler saw in a second, profiled run of
    ``profiled_calls`` calls (default ``n_calls``: the profiler's cost
    grows with the ops it records, an eager step's thousands among them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_calls):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    profiled_calls = profiled_calls or n_calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled_calls):
            run()
        torch.cuda.synchronize()
    profiled_steps = steps * profiled_calls / n_calls
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:    # CPU ops would count twice
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            per_kernel[ev.key] = us / 1e3 / profiled_steps
    device_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": steps, "profiled_steps": profiled_steps,
            "wall_ms_per_step": wall_ms,
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
    decode once an application a step; the published Zamba2 hybrid's
    scan once a group of B/C a layer an admission group (2 x 81), flash
    once an application a group and its decode kernel (paged or slot)
    once an application a step (13 each), and no FFN kernel (its GeGLU
    runs as cuBLAS matmuls)."""
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
    check(all(len(g) <= engine._batch_rows() for g in groups),
          f"{cfg.arch_id}: an admission group exceeds "
          f"{engine._batch_rows()} rows {groups}")
    n_groups, steps = len(groups), graph["steps"]
    if cfg.published_hybrid:
        decode = "paged_decode_attention" if paged else "decode_attention"
        expected = {"ssd_scan": cfg.ssm.n_groups * cfg.n_layers * n_groups,
                    "flash_attention": cfg.n_apps * n_groups,
                    decode: cfg.n_apps * steps, "fused_ffn": 0}
    elif cfg.has_shared_attn:
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
        if cfg.backbone_kind == "moe":
            expected["fused_ffn"] = moe_ffn_per_layer(cfg) * cfg.n_layers \
                * (n_groups + steps)
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
    if ((cfg.backbone_kind == "attn" or cfg.has_shared_attn)
            and not cfg.published_hybrid):
        check((launches.get("fused_ffn", 0) > 0) == cfg.gated_mlp,
              f"{cfg.arch_id} continuous serve: fused_ffn launched "
              f"{launches.get('fused_ffn', 0)} times")
    out["budgets"] = {c.rid: c.budget for c in srv.completed}
    out["stream"] = stream
    return out


def published_hybrid_phase(dev) -> dict:
    """zamba2-7b-instruct (Zamba2 as published) in bf16 at full width and
    depth through the paged continuous serve (``continuous_serve_phase``:
    launches counted from a reset just before the stream, each kernel's
    count per layer, application and group checked); its launches under
    the path's name."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config("zamba2-7b-instruct")
    params = init_params(cfg, seed=0, device=dev)
    served = continuous_serve_phase(dev, cfg, params, paged=True)
    return {"zamba2-7b-instruct continuous serve (paged)":
            served["launches"]}


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
    integer_sandwich(fitted, sol)
    return out


def integer_sandwich(fitted, sol, device=None) -> dict:
    """The paper's integer step on the card-fitted problem: ``solve`` with
    each integer method, the eq-41 sandwich at l*, held to
    tests/test_core_integer.py's ordering (J(l*) above every integer
    point, exhaustive and coordinate at least rounding, rounding at least
    J_bar), then the loop closed: the deployed budgets through the torch
    DES lane (simulate_fifo_batch, 16 seeds x 10,000 queries at lambda
    0.1, the card-fitted service times), whose mean system time must hold
    the P-K prediction within 3 x its 95% CI."""
    from repro_torch.core import sandwich, solve
    from repro_torch.queueing_sim import (ci95, generate_streams,
                                          pk_prediction,
                                          simulate_fifo_batch)

    by_method = {}
    for m in ("exhaustive", "coordinate", "round"):
        s_m = solve(fitted, integer_method=m)
        by_method[m] = {"lengths_int": s_m.lengths_int.astype(int).tolist(),
                        "value_int": s_m.value_int}
    sw = sandwich(fitted, sol.lengths_cont)
    j = {k: v for k, v in sw.items() if k.startswith("J_")}
    eps = 1e-12
    check(j["J_continuous"] >= max(j["J_int_exhaustive"],
                                   j["J_int_coordinate"]) - eps
          and min(j["J_int_exhaustive"], j["J_int_coordinate"])
          >= j["J_int_round"] - eps
          and j["J_int_round"] >= j["J_bar_lower_bound"],
          f"integer sandwich out of order: {j}")
    check(by_method["exhaustive"]["lengths_int"]
          == sw["l_exhaustive"].astype(int).tolist(),
          "solve(exhaustive) and sandwich disagree")
    lam = fitted.server.lam
    deployed = np.asarray(sol.lengths_int, dtype=np.float64)
    batch = generate_streams(fitted.tasks, lam, DES_SEEDS, DES_QUERIES,
                             seed=0)
    stats = simulate_fifo_batch(fitted, deployed, batch, backend="torch",
                                device=device)
    des_mean = float(stats.mean_system_time.mean())
    des_ci = float(ci95(stats.mean_system_time))
    pk = pk_prediction(fitted, deployed)["mean_system_time"]
    out = {"phase": "integer_sandwich", "by_method": by_method,
           **{k: (v.tolist() if isinstance(v, np.ndarray) else v)
              for k, v in sw.items()},
           "closed_loop": {"lam": lam, "seeds": DES_SEEDS,
                           "queries": DES_QUERIES,
                           "budgets": deployed.astype(int).tolist(),
                           "pk_mean_system_time_s": pk,
                           "des_mean_system_time_s": des_mean,
                           "des_ci95_s": des_ci,
                           "pk_minus_des_over_ci": (pk - des_mean) / des_ci}}
    print(json.dumps(out))
    check(abs(pk - des_mean) <= 3 * des_ci,
          f"P-K {pk} outside the DES mean {des_mean} +- 3 x {des_ci}")
    return out


# ------------------------------------------------------------- DES lanes
# The repo's DES benchmarks: BENCH_disciplines.json's grid (three policies,
# lambda at rho_u300 0.5 / 0.65 / 0.8, 16 seeds x 10,000 queries, window
# 512), BENCH_multiserver.json's (c 2 / 4 x rho 0.6 / 0.9, 16 x 10,000) and
# benchmarks/resilience_bench.py's retry lane (rho 0.95, exponential
# services of mean 1, 20,000 queries, here 16 seeded streams).
DES_LSTAR = (0.0, 340.0, 0.0, 0.0, 345.0, 30.0)   # ~ paper Table I l*
DES_RHOS_U300 = (0.5, 0.65, 0.8)
DES_SEEDS, DES_QUERIES, DES_WINDOW = 16, 10_000, 512
DES_MGC_CELLS = ((2, 0.6), (2, 0.9), (4, 0.6), (4, 0.9))
DES_LL_RTOL = {0.6: 0.15, 0.9: 0.05}   # multiserver_bench.py's allowance
DES_RETRY_QUERIES, DES_RETRY_RHO = 20_000, 0.95
DES_TAUS = (2.0, 200.0)
DES_TOL_NUMPY, DES_TOL_ORACLE = 1e-9, 1e-10
FP64_FLOPS = 34e12     # H100 SXM fp64 outside the tensor cores (data sheet)
DES_REPLACES = {
    "des_lindley": "src/repro/queueing_sim/batched.py:85",
    "des_free_server": "src/repro/queueing_sim/multiserver.py:115",
    "des_windowed": "src/repro/queueing_sim/disciplines.py:376",
    "des_impatience": "src/repro/queueing_sim/impatience.py:255",
}
# each lane's wrapper in kernels/des_scan.py (its plain version: + "_plain")
DES_WRAPPERS = {"des_lindley": "lindley", "des_free_server": "free_server",
                "des_windowed": "windowed",
                "des_impatience": "impatience_pass"}


def timed_call(fn) -> tuple:
    """``(fn(), its CUDA-event ms)``: one call, for the plain versions,
    whose output is then checked."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def host_call(fn) -> tuple:
    """``(fn(), its host-clock ms)``, for the NumPy lanes."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def step_latency_ns(dev, flush) -> float:
    """One dependent Lindley step (max, add) on one thread, in ns: the
    latency the lanes' sequential floor multiplies."""
    from repro_torch.kernels import des_scan

    out = torch.zeros(1, dtype=torch.float64, device=dev)
    steps = 1 << 22
    ms = median_ms(lambda: des_scan.step_probe(out, 0.5, 1e-3, steps),
                   flush, reps=3)
    return ms * 1e6 / steps


@contextlib.contextmanager
def recorded_calls(module, names):
    """Record every call of ``module.<name>`` made inside the block, as
    ``{"args": its bound arguments, "out": its result}``: the inputs the
    main path handed each kernel and what the kernel returned there. The
    wrappers still run (and count their launches) as they would."""
    calls = {nm: [] for nm in names}
    orig = {nm: getattr(module, nm) for nm in names}

    def recorder(nm):
        sig = inspect.signature(orig[nm])

        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            out = orig[nm](*args, **kwargs)
            calls[nm].append({"args": dict(bound.arguments), "out": out})
            return out
        return call

    for nm in names:
        setattr(module, nm, recorder(nm))
    try:
        yield calls
    finally:
        for nm, fn in orig.items():
            setattr(module, nm, fn)


def _stacked(calls) -> dict:
    """Several calls' arguments stacked along the streams, for one plain
    pass over all of them: tensors concatenated, a scalar kept where every
    call passed the same one, else spread into a per-stream tensor."""
    first = [next(iter(c["args"].values())) for c in calls]
    out = {}
    for k, v0 in calls[0]["args"].items():
        vs = [c["args"][k] for c in calls]
        if torch.is_tensor(v0):
            out[k] = torch.cat(vs)
        elif all(v == v0 for v in vs):
            out[k] = v0
        else:
            dtype = torch.float64 if isinstance(v0, float) else None
            out[k] = torch.cat([torch.full((f.shape[0],), v, dtype=dtype,
                                           device=f.device)
                                for f, v in zip(first, vs)])
    return out


def _plain_err(got: tuple, want: tuple) -> float:
    """Largest |kernel - plain| over a lane's outputs (NaN where both are
    NaN counts 0; any other mismatch of NaNs or of integer outputs is
    inf). The checks ask for 0: bitwise equal."""
    err = 0.0
    for g, w in zip(got, want):
        if not g.is_floating_point():
            err = max(err, 0.0 if torch.equal(g, w) else float("inf"))
        else:
            err = max(err, _des_err(g.cpu(), w.cpu()))
    return err


def _des_err(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    both = ~(np.isnan(a) & np.isnan(b))
    if np.any(np.isnan(a[both]) | np.isnan(b[both])):
        return float("inf")
    return float(np.max(np.abs(a[both] - b[both]), initial=0.0))


def kernel_vs_plain(name, calls, flush, reps) -> dict:
    """The lane's kernel timed on every input the main path gave it, and
    its recorded outputs there held bitwise against one plain pass on the
    card over those inputs stacked along the streams."""
    from repro_torch.kernels import des_scan

    wrapper = DES_WRAPPERS[name]
    kernel = getattr(des_scan, wrapper)
    plain = getattr(des_scan, wrapper + "_plain")
    ms = [median_ms(lambda c=c: kernel(**c["args"]), flush, reps)
          for c in calls]
    p_out, plain_ms = timed_call(lambda: plain(**_stacked(calls)))
    rows = [c["out"][0].shape[0] for c in calls]
    err = max(_plain_err(c["out"], want) for c, want in
              zip(calls, zip(*(torch.split(x, rows) for x in p_out))))
    check(err == 0.0, f"{name} differs from its plain version ({err})")
    return {"ms": sum(ms), "ms_per_launch": ms, "plain_ms": plain_ms,
            "plain_err": err}


def des_row(name, launches, kvp, numpy_ms, nbytes, ops, chain_steps,
            step_ns, **extra) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_FLOPS * 1e3
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/des_scan.cu",
            "replaces": DES_REPLACES[name], "launches": launches,
            "max_abs_err": kvp["plain_err"], "ms": kvp["ms"],
            "plain_ms": kvp["plain_ms"], "numpy_ms": numpy_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "sequential_floor_ms": chain_steps * step_ns * 1e-6,
            "library_ms": None, "ms_per_launch": kvp["ms_per_launch"],
            **extra}


def des_phase(dev, flush) -> list:
    """The DES lanes at the repo's DES benchmark sizes (see DES_*): the
    main path through the simulator's entry points with ``backend="torch"``
    (counts set to 0 before, read after; every kernel call recorded), then
    each kernel on exactly the inputs the main path gave it: bitwise
    against one plain pass on the card over all of them, against the NumPy
    lane (1e-9, after the heapq fallback) and, the windowed lane, against
    the heapq oracle (1e-10, 6 streams a discipline). Every row covers all
    of its lane's launches on the main path. Returns the ``des_lanes``
    rows."""
    from repro_torch.core import mgc_wait_np, paper_problem
    from repro_torch.data.predictor import LengthPredictor
    from repro_torch.kernels import LAUNCHES, des_scan, reset_launches
    from repro_torch.queueing_sim import (RetryPolicy, ci95, event_loop,
                                          free_server_numpy,
                                          free_server_torch,
                                          generate_streams, impatience_numpy,
                                          impatience_torch, lindley_numpy,
                                          summarize_impatience, sweep,
                                          sweep_disciplines,
                                          windowed_start_finish)
    from repro_torch.queueing_sim.batched import _service_table

    t_phase = time.perf_counter()
    step_ns = step_latency_ns(dev, flush)
    prob = paper_problem(lam=0.1, alpha=30.0)
    tasks = prob.tasks
    lstar = np.asarray(DES_LSTAR)
    policies = {"optimal": lstar, "uniform_100": np.full(6, 100.0),
                "uniform_300": np.full(6, 300.0)}
    pi = np.asarray(tasks.pi)
    es300 = float(np.sum(pi * _service_table(prob, np.full(6, 300.0))))
    lams = [r / es300 for r in DES_RHOS_U300]
    keyed = ("fifo", "sjf", "priority", "spjf")

    # ---- the main path: the simulator's entry points on the card
    t_tab = _service_table(prob, lstar)
    es = float(np.sum(pi * t_tab))
    mgc_batches = [generate_streams(tasks, rho * c / es, DES_SEEDS,
                                    DES_QUERIES, seed=0)
                   for c, rho in DES_MGC_CELLS]
    arr_mgc = np.stack([b.arrivals for b in mgc_batches])
    svc_mgc = t_tab[np.stack([b.types for b in mgc_batches])]
    c_mgc = np.array([c for c, _ in DES_MGC_CELLS])[:, None]
    r = np.random.default_rng(11)
    shape = (DES_SEEDS, DES_RETRY_QUERIES)
    a_ret = np.cumsum(r.exponential(1.0 / DES_RETRY_RHO, size=shape), axis=1)
    s_ret = r.exponential(1.0, size=shape)
    policies_ret = [RetryPolicy(patience=tau, max_retries=3, backoff0=0.5,
                                orphaned_service=orph)
                    for tau in DES_TAUS for orph in (True, False)]
    torch.cuda.synchronize()
    reset_launches()
    with recorded_calls(des_scan, DES_WRAPPERS.values()) as rec:
        t_main = time.perf_counter()
        res = sweep_disciplines(prob, policies, lams, disciplines=keyed,
                                n_seeds=DES_SEEDS, n_queries=DES_QUERIES,
                                window=DES_WINDOW,
                                predictor=LengthPredictor(),
                                backend="torch", device=dev)
        fifo_sweep = sweep(prob, policies, lams, n_seeds=DES_SEEDS,
                           n_queries=DES_QUERIES, backend="torch",
                           device=dev)
        st_mgc, _ = free_server_torch(arr_mgc, svc_mgc, c_mgc, device=dev)
        ret = [impatience_torch(a_ret, s_ret, pol, device=dev)
               for pol in policies_ret]
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t_main
    launches = {k: LAUNCHES[k] for k in DES_REPLACES}
    calls = {k: rec[w] for k, w in DES_WRAPPERS.items()}
    print(json.dumps({"phase": "des_main_path", "seconds": main_s,
                      "launches": launches}))
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the des main path")
        check(len(calls[name]) == n,
              f"{name}: {len(calls[name])} calls for {n} launches")
    # tests/test_disciplines.py's pin of sweep_disciplines against sweep
    check(bool(np.allclose(fifo_sweep.mean_system_time,
                           res["fifo"].mean_system_time, rtol=0,
                           atol=DES_TOL_NUMPY)),
          "sweep(fifo, torch) and sweep_disciplines' fifo disagree")
    for d in keyed:
        out = {"phase": "des_discipline", "discipline": d,
               "policies": list(policies), "lams": lams,
               "mean_wait": res[d].mean_wait.tolist(),
               "mean_system_time": res[d].mean_system_time.tolist(),
               "ci_system_time": res[d].ci_system_time.tolist(),
               "overflow_frac": res[d].overflow_frac.tolist()}
        print(json.dumps(out))
        check(bool(np.all(np.isfinite(res[d].mean_system_time))),
              f"{d}: non-finite sweep means")
    host = lambda t: t.cpu().numpy()
    rows = []

    # Lindley: sweep's FIFO pass over the grid
    kvp = kernel_vs_plain("des_lindley", calls["des_lindley"], flush, 25)
    numpy_ms, err_np, nbytes, ops, chain = 0.0, 0.0, 0, 0, 0
    for c in calls["des_lindley"]:
        a, s = host(c["args"]["arrivals"]), host(c["args"]["services"])
        want, t = host_call(lambda: lindley_numpy(a, s))
        numpy_ms += t
        err_np = max([err_np] + [_des_err(host(g), w)
                                 for g, w in zip(c["out"], want)])
        nbytes, ops, chain = nbytes + 4 * a.size * 8, ops + 2 * a.size, \
            chain + a.shape[1]
    check(err_np <= DES_TOL_NUMPY, f"des_lindley vs lindley_numpy {err_np}")
    rows.append(des_row("des_lindley", launches["des_lindley"], kvp,
                        numpy_ms, nbytes, ops, chain, step_ns,
                        shapes=[list(c["args"]["arrivals"].shape)
                                for c in calls["des_lindley"]],
                        max_err_numpy=err_np))

    # the windowed argmin: sweep_disciplines' sjf / priority / spjf
    # launches, a lambda each, and fifo's keys (the arrivals) on the same
    # streams, which the main path serves through Lindley instead
    wcalls = calls["des_windowed"]
    labels = [d for _ in lams for d in keyed if d != "fifo"]
    check(len(wcalls) == len(labels),
          f"des_windowed: {len(wcalls)} launches, expected {len(labels)}")
    fifo_calls = []
    for c in wcalls[::len(keyed) - 1]:
        args = {**c["args"], "kp": c["args"]["ap"]}
        fifo_calls.append({"args": args, "out": des_scan.windowed(**args)})
    wcalls, labels = wcalls + fifo_calls, labels + ["fifo"] * len(lams)
    kvp = kernel_vs_plain("des_windowed", wcalls, flush, 5)
    W = DES_WINDOW
    by_d = {d: [j for j, x in enumerate(labels) if x == d] for d in keyed}
    w_numpy_ms = dict.fromkeys(keyed, 0.0)
    w_err_np, w_err_or = dict.fromkeys(keyed, 0.0), dict.fromkeys(keyed, 0.0)
    nbytes, ops, chain = 0, 0, 0
    for j, (c, d) in enumerate(zip(wcalls, labels)):
        B, nw = c["args"]["ap"].shape
        n = nw - W
        arr, svc, keys = (host(c["args"][k][:, :n]) for k in ("ap", "sp",
                                                                "kp"))
        st_t, fi_t, _ = windowed_start_finish(arr, svc, keys, W,
                                              backend="torch", device=dev)
        (st_n, fi_n, _), t = host_call(
            lambda: windowed_start_finish(arr, svc, keys, W))
        w_numpy_ms[d] += t
        w_err_np[d] = max(w_err_np[d], _des_err(st_t, st_n),
                          _des_err(fi_t, fi_n))
        for i in (0, B - 1):
            ref = event_loop(arr[i], svc[i], keys[i])
            w_err_or[d] = max(w_err_or[d], _des_err(st_t[i], ref[0]),
                              _des_err(fi_t[i], ref[1]))
        if d != "fifo":
            nbytes += (3 * B * nw + 2 * B * n) * 8 + B
            ops, chain = ops + 3 * B * n * W, chain + n
    for d in keyed:
        check(w_err_np[d] <= DES_TOL_NUMPY,
              f"des_windowed {d} vs windowed_numpy {w_err_np[d]}")
        check(w_err_or[d] <= DES_TOL_ORACLE,
              f"des_windowed {d} vs heapq {w_err_or[d]}")
    ms_d = {d: sum(kvp["ms_per_launch"][j] for j in js)
            for d, js in by_d.items()}
    ovf = {d: float(torch.cat([wcalls[j]["out"][2] for j in js])
                    .float().mean()) for d, js in by_d.items()}
    main = [j for j, d in enumerate(labels) if d != "fifo"]
    kvp = {**kvp, "ms": sum(kvp["ms_per_launch"][j] for j in main),
           "ms_per_launch": [kvp["ms_per_launch"][j] for j in main]}
    rows.append(des_row(
        "des_windowed", launches["des_windowed"], kvp,
        sum(w_numpy_ms[d] for d in keyed if d != "fifo"), nbytes, ops,
        chain, step_ns, shape_per_launch=list(wcalls[0]["args"]["ap"].shape),
        window=W, disciplines_per_launch=labels[:len(main)],
        plain_streams=sum(c["args"]["ap"].shape[0] for c in wcalls),
        plain_covers="every main-path launch and fifo's keys on its streams",
        ms_by_discipline=ms_d, numpy_ms_by_discipline=w_numpy_ms,
        max_err_numpy=w_err_np, max_err_oracle=w_err_or,
        kernel_overflow_frac=ovf))

    # the free server: the multiserver grid's four cells in one call
    kvp = kernel_vs_plain("des_free_server", calls["des_free_server"],
                          flush, 25)
    numpy_ms, err_np, nbytes, ops, chain = 0.0, 0.0, 0, 0, 0
    for c in calls["des_free_server"]:
        a, s = host(c["args"]["arrivals"]), host(c["args"]["services"])
        free0 = host(c["args"]["free0"])
        cs = np.isfinite(free0).sum(axis=1)
        want, t = host_call(lambda: free_server_numpy(a, s, cs))
        numpy_ms += t
        err_np = max([err_np] + [_des_err(host(g), w)
                                 for g, w in zip(c["out"], want)])
        nbytes += 4 * a.size * 8 + free0.size * 8
        ops, chain = ops + int(np.sum(cs + 2)) * a.shape[1], chain + a.shape[1]
    check(err_np <= DES_TOL_NUMPY, f"des_free_server vs numpy {err_np}")
    warm = DES_QUERIES // 4
    gaps = []
    for i, (c, rho) in enumerate(DES_MGC_CELLS):
        waits = (st_mgc[i] - arr_mgc[i])[:, warm:].mean(axis=1)
        lam = rho * c / es
        pred_w = float(mgc_wait_np(tasks, lstar, lam, c))
        ci = float(ci95(waits))
        gap = float(waits.mean() - pred_w)
        gaps.append({"c": c, "rho": rho, "lam": lam,
                     "des_mean_wait": float(waits.mean()), "ci95": ci,
                     "lee_longton_wait": pred_w, "gap": gap,
                     "rel_error": gap / pred_w,
                     "allowance_rel": DES_LL_RTOL[rho]})
        check(abs(gap) <= ci + DES_LL_RTOL[rho] * pred_w,
              f"c={c} rho={rho}: DES vs Lee-Longton {gap}")
    print(json.dumps({"phase": "des_multiserver", "cells": gaps}))
    rows.append(des_row("des_free_server", launches["des_free_server"], kvp,
                        numpy_ms, nbytes, ops, chain, step_ns,
                        shapes=[list(c["args"]["arrivals"].shape)
                                for c in calls["des_free_server"]],
                        max_err_numpy=err_np))

    # the impatience pass: four retry policies, one launch each, against
    # one plain pass over the four policies' streams (per-stream patience
    # and orphaned mode) and against the NumPy lane
    kvp = kernel_vs_plain("des_impatience", calls["des_impatience"], flush, 5)
    i_numpy_ms, i_err, summaries = {}, 0.0, []
    for pol, got in zip(policies_ret, ret):
        kind = "orphaned" if pol.orphaned_service else "reneging"
        tag = f"tau{pol.patience:g}_{kind}"
        want, i_numpy_ms[tag] = host_call(
            lambda: impatience_numpy(a_ret, s_ret, pol))
        err = max(_des_err(got.start, want.start),
                  _des_err(got.finish, want.finish),
                  _des_err(got.wait, want.wait))
        check(err <= DES_TOL_NUMPY
              and np.array_equal(got.served, want.served)
              and np.array_equal(got.n_attempts, want.n_attempts),
              f"des_impatience {tag} vs impatience_numpy {err}")
        i_err = max(i_err, err)
        summaries.append({"policy": tag,
                          **summarize_impatience(got, a_ret, s_ret, pol)})
    print(json.dumps({"phase": "des_impatience", "streams": DES_SEEDS,
                      "queries": DES_RETRY_QUERIES,
                      "summaries": summaries}))
    nbytes, ops, chain = 0, 0, 0
    for c in calls["des_impatience"]:
        S, E = c["args"]["t_ev"].shape
        N = c["args"]["services"].numel()
        nbytes += 3 * S * E * 8 + N * 8 + N * (1 + 4 * 8)
        ops, chain = ops + 6 * S * E, chain + E
    rows.append(des_row(
        "des_impatience", launches["des_impatience"], kvp,
        sum(i_numpy_ms.values()), nbytes, ops, chain, step_ns,
        streams=DES_SEEDS, queries=DES_RETRY_QUERIES,
        events_per_stream=int(calls["des_impatience"][0]["args"]["t_ev"]
                              .shape[1]),
        policies_per_launch=list(i_numpy_ms),
        plain_streams=DES_SEEDS * len(policies_ret),
        numpy_ms_by_policy=i_numpy_ms, max_err_numpy=i_err))
    print(json.dumps({"phase": "des", "seconds": time.perf_counter() - t_phase,
                      "step_latency_ns": step_ns, "rows": rows}))
    return rows


# --------------------------------------------------------------- sweeps
# tests/test_solver_grid.py's acceptance grid (lambda x alpha x l_max), its
# three PGA-fallback cells, a c-grid (c 1 / 2 / 4, lambda in 5 steps up to
# 0.9 c lambda_sat) and a finer grid of 10,000 cells on the same axes
SWEEP_LAMS = np.linspace(0.05, 0.5, 10)
SWEEP_ALPHAS = np.array([10.0, 20.0, 30.0, 45.0, 60.0])
SWEEP_LMAXS = np.array([1024.0, 32768.0])
SWEEP_FINE = (100, 50)        # the 10,000-cell grid's lambdas x alphas
SWEEP_CS = (1, 2, 4)
SWEEP_REF_CELLS = 12          # reference_check cells of the 100-cell grid
SWEEP_TOL = 1e-6              # continuous optima (the grid's contract)
SWEEP_EXACT = ("lengths_int", "feasible", "stable", "used_pga",
               "fp_converged", "fp_iterations", "pga_iterations")
# Armijo cells that stop apart on the card and the host (pga_iterations
# differ or l* >= SWEEP_TOL apart) are held to J(l*) within
# SWEEP_ARMIJO_RTOL and to the gap the stopping test allows (see
# _check_apart), at the grid's tol and re-solved at SWEEP_TIGHT_TOL
SWEEP_ARMIJO_RTOL = 1e-9
SWEEP_GRID_TOL = 1e-8         # solve_grid's default tol
SWEEP_TIGHT_TOL = 1e-12
SWEEP_EVAL_SEEDS, SWEEP_EVAL_QUERIES = 8, 10_000
SWEEP_EVAL_RTOL = 1e-9        # card lanes against the NumPy backend
SWEEP_EVAL_REASON = (
    "each lane is bitwise equal to its plain version, here run on the "
    "host (backend torch, device cpu); the NumPy backend's Lindley pass is "
    "the cumsum form, which rounds otherwise, so it is held at rtol 1e-9, "
    "atol 1e-12")


def _sweep_grids(tasks) -> dict:
    from repro_torch.sweeps import saturation_rate

    c = np.array(SWEEP_CS, dtype=np.float64)[:, None]
    lam_c = np.linspace(0.18, 0.9, 5)[None, :] * c * saturation_rate(tasks)
    return {
        "grid_100": ((SWEEP_LAMS[:, None, None], SWEEP_ALPHAS[None, :, None],
                      SWEEP_LMAXS[None, None, :]), {}),
        "pga_fallback": ((np.array([1.0, 2.0, 3.0]), 30.0, 32768.0), {}),
        "c_grid": ((lam_c, 30.0, 32768.0), {"c": c}),
        "grid_10000": ((np.linspace(0.05, 0.5, SWEEP_FINE[0])[:, None, None],
                        np.linspace(10.0, 60.0, SWEEP_FINE[1])[None, :, None],
                        SWEEP_LMAXS[None, None, :]), {}),
    }


def _apart(got, want) -> np.ndarray:
    """Flat indices of the Armijo cells that stopped apart: their
    pga_iterations differ or their optima are SWEEP_TOL or more apart."""
    g, w = got.ravel(), want.ravel()
    gap = np.max(np.abs(g.lengths_cont - w.lengths_cont), axis=-1)
    return np.flatnonzero(w.used_pga & g.used_pga & (
        (g.pga_iterations != w.pga_iterations) | (gap >= SWEEP_TOL)))


def _grid_deviation(got, want) -> dict:
    """The card's grid against the same grid on the host: how many cells
    differ in each of SWEEP_EXACT (the iteration counts by how much), the
    worst gap between the continuous optima over the cells the fixed point
    solved, over the Armijo cells that stopped alike and over those that
    stopped apart (``_apart``), and the worst relative gap between the
    objective values J(l*)."""
    gap = np.max(np.abs(got.lengths_cont - want.lengths_cont),
                 axis=-1).ravel()
    pga = want.used_pga.ravel()
    apart = np.zeros_like(pga)
    apart[_apart(got, want)] = True
    out = {"max_abs_cont_deviation": float(gap.max()),
           "max_abs_cont_deviation_fp_cells": float(np.max(gap[~pga],
                                                           initial=0.0)),
           "max_abs_cont_deviation_pga_cells_alike": float(np.max(
               gap[pga & ~apart], initial=0.0)),
           "max_abs_cont_deviation_pga_cells_apart": float(np.max(
               gap[apart], initial=0.0)),
           "pga_cells_apart": int(apart.sum()),
           "max_rel_value_deviation": float(np.max(
               np.abs(got.value_cont - want.value_cont)
               / np.abs(want.value_cont)))}
    for f in SWEEP_EXACT:
        a, b = getattr(got, f), getattr(want, f)
        diff = a != b
        if diff.ndim > got.lam.ndim:
            diff = diff.any(axis=-1)
        out[f"cells_differing_{f}"] = int(diff.sum())
        if f.endswith("iterations") and diff.any():
            out[f"max_abs_diff_{f}"] = int(np.max(np.abs(
                a.astype(np.int64) - b.astype(np.int64))))
    return out


def _check_grid(name: str, dev: dict) -> None:
    """SWEEP_EXACT equal and optima within SWEEP_TOL, but for the Armijo
    cells that stopped apart (``_apart``): their pga_iterations may differ
    and their optima are held by ``_check_apart``. Every cell's J(l*)
    within SWEEP_ARMIJO_RTOL."""
    for f in SWEEP_EXACT:
        allowed = dev["pga_cells_apart"] if f == "pga_iterations" else 0
        check(dev[f"cells_differing_{f}"] <= allowed,
              f"{name}: {f} differs between the card and the host: {dev}")
    for key in ("max_abs_cont_deviation_fp_cells",
                "max_abs_cont_deviation_pga_cells_alike"):
        check(dev[key] < SWEEP_TOL, f"{name}: continuous optima apart: {dev}")
    check(dev["max_rel_value_deviation"] <= SWEEP_ARMIJO_RTOL,
          f"{name}: objective values apart: {dev}")


def _stop_radius(tasks, cell: dict, tol: float) -> tuple:
    """How far from the optimum the Armijo stopping test may leave l*:
    ``(tol / mu + sqrt(2 eps / mu), mu, |grad J|)`` at the cell's l*, with
    mu the least curvature of -J over the free coordinates (``torch.func``
    Hessian of the cell's objective) and eps = N x f64 eps x |J|, what a
    sum of N terms of J can round by. The test |dl| / eta <= tol stops
    once |grad J| <= tol (within tol / mu of the optimum), or once the
    Armijo test can no longer see J rise, the step backtracks to nothing
    and dl rounds to 0 (within sqrt(2 eps / mu))."""
    from repro_torch.core import Problem, ServerParams
    from repro_torch.core.mgc import objective_mgc
    from repro_torch.core.objective import objective

    prob = Problem(tasks=tasks, server=ServerParams(
        cell["lam"], cell["alpha"], cell["l_max"]))
    c = int(cell["c"])
    fn = (lambda v: objective(prob, v)) if c == 1 else \
        (lambda v: objective_mgc(prob, v, c, c))
    lengths = torch.as_tensor(cell["lengths_cont"], dtype=torch.float64)
    h = torch.func.hessian(fn)(lengths).numpy()
    g = torch.func.grad(fn)(lengths).numpy()
    free = (cell["lengths_cont"] > 0) & (cell["lengths_cont"]
                                         < cell["l_max"])
    mu = float(np.linalg.eigvalsh(-h[np.ix_(free, free)]).min()) \
        if free.any() else np.inf
    eps = free.size * np.finfo(np.float64).eps * abs(float(fn(lengths)))
    return (tol / mu + np.sqrt(2.0 * eps / mu), mu,
            float(np.max(np.abs(g[free]), initial=0.0)))


def _check_apart(name: str, tasks, sol, host, dev) -> dict:
    """The Armijo cells of ``sol`` (card) and ``host`` that stopped apart,
    each held to a gap between the two optima of at most twice the
    ``_stop_radius`` at the host's l*, at the grid's tol and re-solved
    on both at SWEEP_TIGHT_TOL, where the integer budgets and flags must
    still agree. On an M/G/1 grid ``reference_check`` (the scalar solve at
    the grid's tol) also measures those cells of the card's grid and of
    the host's."""
    from repro_torch.sweeps import reference_check, solve_grid

    cells = _apart(sol, host)
    flat = host.ravel()
    axes = (flat.lam[cells], flat.alpha[cells], flat.l_max[cells])
    kw = {"c": flat.c[cells], "tol": SWEEP_TIGHT_TOL}
    (tight, card_ms), (tight_host, host_ms) = (
        host_call(lambda d=d: solve_grid(tasks, *axes, device=d, **kw))
        for d in (dev, "cpu"))
    d = _grid_deviation(tight, tight_host)
    for f in SWEEP_EXACT:
        if not f.endswith("iterations"):
            check(d[f"cells_differing_{f}"] == 0,
                  f"{name}: re-solved, {f} differs: {d}")
    rows = []
    for i, cell in enumerate(cells.tolist()):
        row = {"cell": cell, "lam": float(axes[0][i]),
               "alpha": float(axes[1][i]), "l_max": float(axes[2][i]),
               "pga_iterations_card_host": [
                   int(sol.ravel().pga_iterations[cell]),
                   int(flat.pga_iterations[cell])],
               "tight_pga_iterations_card_host": [
                   int(tight.pga_iterations[i]),
                   int(tight_host.pga_iterations[i])]}
        for key, (a, b, t) in {
                "grid_tol": (sol.ravel(), flat, SWEEP_GRID_TOL),
                "tight_tol": (tight, tight_host, SWEEP_TIGHT_TOL)}.items():
            j = cell if key == "grid_tol" else i
            gap = float(np.max(np.abs(a.lengths_cont[j]
                                      - b.lengths_cont[j])))
            radius, mu, grad_inf = _stop_radius(tasks, b.cell(j), t)
            row[key] = {"tol": t, "gap": gap, "allowed": 2.0 * radius,
                        "mu": mu, "host_grad_inf": grad_inf}
            check(gap <= 2.0 * radius,
                  f"{name}: cell {cell} at tol {t:g}: optima {gap:.3g} "
                  f"apart, beyond {2.0 * radius:.3g}: {row}")
        rows.append(row)
    out = {"cells": rows, "tight_card_ms": card_ms,
           "tight_host_ms": host_ms}
    if np.all(host.c == 1):
        out["reference_check_card"], out["reference_check_host"] = (
            reference_check(tasks, g, cells=cells.tolist(), tol=np.inf)
            for g in (sol, host))
    return out


def _eval_gap(got, want) -> tuple:
    """(bitwise equal, worst absolute gap, every float field within
    SWEEP_EVAL_RTOL, atol 1e-12) of two GridEvaluations."""
    same, gap, close = True, 0.0, True
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if not isinstance(b, np.ndarray):
            same &= a == b
            continue
        same &= bool(np.array_equal(a, b))
        if b.dtype.kind == "f" and b.size:
            check(np.array_equal(np.isfinite(a), np.isfinite(b)),
                  f"{f.name}: finite cells differ")
            fin = np.isfinite(b)
            gap = max(gap, float(np.max(np.abs(a[fin] - b[fin]),
                                        initial=0.0)))
            close &= bool(np.allclose(a[fin], b[fin], rtol=SWEEP_EVAL_RTOL,
                                      atol=1e-12))
    return same, gap, close


def sweeps_phase(dev) -> dict:
    """``repro_torch.sweeps`` on the card: each grid of ``_sweep_grids``
    solved twice on the card (cold, warm) and once on the host, held to
    the host run (SWEEP_EXACT fields equal, optima within SWEEP_TOL; the
    Armijo cells that stop apart re-solved at SWEEP_TIGHT_TOL, see
    ``_check_grid``); ``reference_check`` on 12 of the 100-cell grid's
    cells; then ``evaluate_solution(backend="torch")`` on its
    integer budgets (8 seeds x 10,000 queries), one M/G/2 cell and one
    SJF cell, the DES lanes' launches counted (0 just before, read just
    after), each result bitwise against the lanes' plain versions and
    within SWEEP_EVAL_RTOL of the NumPy backend. Times are printed, not
    gated. Returns the phase's record with the lanes' launches."""
    from repro_torch.core import paper_problem
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.sweeps import (evaluate_cells, evaluate_solution,
                                    reference_check, solve_grid)

    t_phase = time.perf_counter()
    tasks = paper_problem().tasks
    grids, sols, hosts = {}, {}, {}
    for name, (args, kw) in _sweep_grids(tasks).items():
        cold, warm = (host_call(lambda: solve_grid(tasks, *args, device=dev,
                                                   **kw)) for _ in range(2))
        sol, warm_ms = warm
        host, cpu_ms = host_call(lambda: solve_grid(tasks, *args,
                                                    device="cpu", **kw))
        grids[name] = {
            "cells": sol.n_cells, "shape": list(sol.shape),
            "card_cold_ms": cold[1], "card_warm_ms": warm_ms,
            "cpu_ms": cpu_ms, "cells_per_s_card": sol.n_cells / warm_ms * 1e3,
            "cells_per_s_cpu": sol.n_cells / cpu_ms * 1e3,
            "max_fp_iterations": int(sol.fp_iterations.max()),
            "max_pga_iterations": int(sol.pga_iterations.max()),
            "used_pga": int(sol.used_pga.sum()),
            "feasible": int(sol.feasible.sum()),
            "stable": int(sol.stable.sum()),
            **_grid_deviation(sol, host)}
        print(json.dumps({"grid": name, **grids[name]}), flush=True)
        sols[name], hosts[name] = sol, host
    for name, row in grids.items():
        _check_grid(name, row)
        check(bool(np.all(sols[name].feasible & sols[name].stable)),
              f"{name}: unstable")
    for name in grids:
        if grids[name]["pga_cells_apart"]:
            apart = _check_apart(name, tasks, sols[name], hosts[name], dev)
            grids[name]["pga_cells_apart_resolved"] = apart
            print(json.dumps({"grid": name, "apart": apart}), flush=True)

    flat = sols["grid_100"].ravel()
    pga_cells = np.flatnonzero(flat.used_pga)
    fp_cells = np.flatnonzero(~flat.used_pga)
    half = SWEEP_REF_CELLS // 2
    cells = np.concatenate([
        pga_cells[np.linspace(0, len(pga_cells) - 1, half).astype(int)],
        fp_cells[np.linspace(0, len(fp_cells) - 1, half).astype(int)]])
    ref_dev, ref_ms = host_call(lambda: reference_check(
        tasks, sols["grid_100"], cells=cells.tolist()))

    # the evaluation's main path: counts set to 0 just before, read after
    sol = sols["grid_100"]
    cell = flat.cell(int(np.flatnonzero((flat.lam == SWEEP_LAMS[5])
                                        & (flat.alpha == 30.0)
                                        & (flat.l_max == 32768.0))[0]))
    ekw = dict(n_seeds=SWEEP_EVAL_SEEDS, n_queries=SWEEP_EVAL_QUERIES,
               seed=0)
    cases = {
        "grid_100": lambda **b: evaluate_solution(tasks, sol, **ekw, **b),
        "mgc_c2": lambda **b: evaluate_cells(
            tasks, 2.0 * cell["lam"], cell["lengths_int"], c=2, **ekw, **b),
        "sjf": lambda **b: evaluate_cells(
            tasks, cell["lam"], cell["lengths_int"], discipline="sjf",
            **ekw, **b)}
    torch.cuda.synchronize()
    reset_launches()
    card = {k: host_call(lambda f=f: f(backend="torch", device=dev))
            for k, f in cases.items()}
    launches = {k: LAUNCHES[k] for k in ("des_lindley", "des_free_server",
                                         "des_windowed")}
    check(all(n > 0 for n in launches.values()),
          f"a DES lane did not launch in the evaluation: {launches}")
    evaluation = {}
    for k, f in cases.items():
        plain, plain_ms = host_call(lambda: f(backend="torch", device="cpu"))
        numpy_ev, numpy_ms = host_call(lambda: f(backend="numpy"))
        same, _, _ = _eval_gap(card[k][0], plain)
        check(same, f"evaluation {k}: the card's lanes differ from their "
                    "plain versions")
        same_np, gap, close = _eval_gap(card[k][0], numpy_ev)
        check(close, f"evaluation {k}: {gap} from NumPy")
        ev = card[k][0]
        evaluation[k] = {"cells": int(ev.lam.shape[0]), "card_ms": card[k][1],
                         "plain_host_ms": plain_ms, "numpy_ms": numpy_ms,
                         "bitwise_plain": same, "bitwise_numpy": same_np,
                         "max_abs_gap_numpy": gap,
                         "covered": int(np.sum(ev.covered))}
    out = {"phase": "sweeps", "grids": grids,
           "reference_check": {"cells": cells.tolist(),
                               "max_abs_deviation": ref_dev, "ms": ref_ms},
           "evaluation": evaluation, "eval_rtol_numpy": SWEEP_EVAL_RTOL,
           "eval_reason": SWEEP_EVAL_REASON, "launches": launches,
           "seconds": time.perf_counter() - t_phase}
    print(json.dumps(out))
    return out


def _timed_resolves(ctl) -> list:
    """Wrap ``ctl.resolve`` to record each call's host ms and whether it
    deployed a solution. On the card the re-solve ends in the host read
    of its result, so the clock covers finished device work."""
    calls = []
    resolve = ctl.resolve

    def timed():
        t0 = time.perf_counter()
        deployed = resolve()
        calls.append(((time.perf_counter() - t0) * 1e3, deployed))
        return deployed
    ctl.resolve = timed
    return calls


def _resolve_stats(calls) -> dict:
    """The deployed re-solves' ms: the first apart, then median and p90
    of all of them."""
    ms = [t for t, deployed in calls if deployed]
    if not ms:
        return {"n": 0, "calls": len(calls)}
    return {"n": len(ms), "calls": len(calls), "first_ms": ms[0],
            "median_ms": float(np.median(ms)),
            "p90_ms": float(np.percentile(ms, 90)),
            "total_ms": float(np.sum(ms))}


def replay_phase(dev) -> dict:
    """The closed loop's virtual lane, re-solving on the card: the
    reference's convergence run (paper_problem, a stationary trace of
    REPLAY_QUERIES at lambda 0.1, seed 7, blocks of REPLAY_BLOCK) once
    with the controller's solve_grid on the card and once on the host.
    Checks: the same budgets deployed in every block, hence bitwise the
    same services and waits; more than 10 re-solves; final budgets
    within REPLAY_ORACLE_TOL tokens of core.solve's oracle. Prints each
    side's re-solve ms (median, p90) and the run's wall time."""
    from repro_torch.core import paper_problem, solve
    from repro_torch.queueing_sim import Segment, generate_drift_trace
    from repro_torch.serving import ReplayConfig, ReplayHarness

    prob = paper_problem()
    trace = generate_drift_trace(
        prob.tasks, [Segment(REPLAY_QUERIES, prob.server.lam)], seed=7)
    oracle = solve(prob).lengths_int.astype(np.int64)
    runs = {}
    for side, device in (("card", dev), ("host", "cpu")):
        h = ReplayHarness(prob, ReplayConfig(block_size=REPLAY_BLOCK),
                          device=device)
        calls = _timed_resolves(h.controller)
        t0 = time.perf_counter()
        res = h.run_virtual(trace)
        runs[side] = {"res": res, "wall_s": time.perf_counter() - t0,
                      "resolve": _resolve_stats(calls)}
    card, host = runs["card"]["res"], runs["host"]["res"]
    same_blocks = (len(card.blocks) == len(host.blocks) and all(
        np.array_equal(a.budgets, b.budgets)
        for a, b in zip(card.blocks, host.blocks)))
    same_arrays = all(np.array_equal(getattr(card, f), getattr(host, f))
                      for f in ("budgets", "services", "waits", "correct"))
    gap = int(np.max(np.abs(card.final_budgets - oracle)))
    out = {"phase": "replay", "queries": REPLAY_QUERIES,
           "block_size": REPLAY_BLOCK, "n_blocks": len(card.blocks),
           "n_resolves": card.n_resolves,
           "n_resolves_host": host.n_resolves,
           "resolve_card": runs["card"]["resolve"],
           "resolve_host": runs["host"]["resolve"],
           "wall_s_card": runs["card"]["wall_s"],
           "wall_s_host": runs["host"]["wall_s"],
           "final_budgets": card.final_budgets.tolist(),
           "oracle_budgets": oracle.tolist(), "max_gap_to_oracle": gap,
           "same_budgets_every_block": same_blocks,
           "bitwise_services_waits": same_arrays,
           "estimator": card.estimator_state,
           "report": dataclasses.asdict(card.report(prob))}
    print(json.dumps(out), flush=True)
    check(same_blocks, "replay: the card and the host deployed other "
                       "budgets in some block")
    check(same_arrays, "replay: waits or services differ between card "
                       "and host")
    check(card.n_resolves == host.n_resolves > 10,
          f"replay: {card.n_resolves} / {host.n_resolves} re-solves")
    check(gap <= REPLAY_ORACLE_TOL,
          f"replay: final budgets {gap} tokens from the oracle")
    return out


def replay_drift_phase(dev) -> dict:
    """The drift mode with every hook: a lambda step (DRIFT_QUERIES at
    lambda0 = 0.1, then DRIFT_QUERIES at 3 lambda0, seed 13, blocks of
    DRIFT_BLOCK), resolve_mode="drift", an AdmissionController on the
    oracle budgets (each re-solve also re-projects its ladder: a second
    solve_grid over the ladder's caps), a Tracer, a MetricsRegistry and
    a StragglerDecode fault; the re-solves on the card. Checks: the drift
    alarm fires after the step, the deployed budget total falls under the
    heavier load, every completed request's span tree is whole. Prints
    the drift history, the ladder's levels and the sheds."""
    from repro_torch.core import paper_problem, solve
    from repro_torch.faults import StragglerDecode
    from repro_torch.obs import (MetricsRegistry, Tracer,
                                 validate_request_trees)
    from repro_torch.queueing_sim import Segment, generate_drift_trace
    from repro_torch.serving import (AdmissionConfig, AdmissionController,
                                     ReplayConfig, ReplayHarness)

    prob = paper_problem()
    lam0 = prob.server.lam
    trace = generate_drift_trace(
        prob.tasks, [Segment(DRIFT_QUERIES, lam0),
                     Segment(DRIFT_QUERIES, 3 * lam0)], seed=13)
    oracle = solve(prob).lengths_int.astype(np.int64)
    cfg = ReplayConfig(block_size=DRIFT_BLOCK, est_halflife=512.0,
                       resolve_mode="drift")
    tracer, metrics = Tracer(), MetricsRegistry()
    h = ReplayHarness(prob, cfg, tracer=tracer, metrics=metrics,
                      admission=AdmissionController(
                          oracle, prob.server.l_max, AdmissionConfig()),
                      faults=StragglerDecode(0.02, 2.0, seed=1), device=dev)
    calls = _timed_resolves(h.controller)
    t0 = time.perf_counter()
    res = h.run_virtual(trace)
    wall = time.perf_counter() - t0
    before = [b for b in res.blocks
              if (b.index + 1) * DRIFT_BLOCK <= DRIFT_QUERIES][-1]
    end = res.blocks[-1]
    alarms = [b.index for b in res.blocks
              if b.drift is not None and b.drift["fired"]]
    after = [i for i in alarms if i * DRIFT_BLOCK >= DRIFT_QUERIES]
    t1 = time.perf_counter()
    trees = validate_request_trees(
        tracer.to_chrome(), np.flatnonzero(res.served_mask()).tolist())
    trees_s = time.perf_counter() - t1
    snap = metrics.as_dict()
    out = {"phase": "replay_drift", "queries": 2 * DRIFT_QUERIES,
           "block_size": DRIFT_BLOCK, "lam": [lam0, 3 * lam0],
           "n_resolves": res.n_resolves,
           "resolved_blocks": [b.index for b in res.blocks if b.resolved],
           "resolve_card": _resolve_stats(calls), "wall_s": wall,
           "alarm_blocks": alarms, "step_block": DRIFT_QUERIES // DRIFT_BLOCK,
           "drift_history": [
               {"block": b.index, **{k: b.drift[k] for k in (
                   "fired", "reason", "n", "predicted_wait",
                   "measured_wait", "rel_err", "rho", "strikes",
                   "overload")}}
               for b in res.blocks if b.drift is not None],
           "levels": [b.level for b in res.blocks],
           "sheds": [b.n_shed for b in res.blocks],
           "admission": {k: v for k, v in res.admission.items()
                         if k != "occupancy"},
           "budgets_before_step": before.budgets.tolist(),
           "budgets_end": end.budgets.tolist(),
           "lam_hat_before_step": before.estimator["lam"],
           "lam_hat_end": end.estimator["lam"],
           "trees": trees, "trees_validate_s": trees_s,
           "metrics": {k: snap[k] for k in ("replay.wait", "replay.service",
                                            "replay.system_time")}}
    print(json.dumps(out), flush=True)
    check(bool(after), f"replay_drift: no alarm after the step "
                       f"(alarms at blocks {alarms})")
    check(end.budgets.sum() < before.budgets.sum(),
          f"replay_drift: budgets {before.budgets.tolist()} -> "
          f"{end.budgets.tolist()} under 3x the load")
    return out


def replay_engine_phase(dev, cfg, params, calibration: dict) -> dict:
    """The closed loop's engine lane on the paper's model: ``run_engine``
    over ``cfg`` (qwen3-8b, full width, bf16; ``params`` the wall serve's
    weights) through a fresh DecodeEngine (capacity 2048, chunk 16, its
    own graph cache), ENGINE_QUERIES requests at ENGINE_LAM with prompts
    of ENGINE_PROMPT tokens, blocks of 8, ServerParams(l_max=128),
    l_init 64, half the budgets jittered, min_services 8; re-solves on
    the card. Launches and graph counts set to 0 just before run_engine
    (its warm-up decode included) and read after. Checks: every decode's
    n_reasoning == min(l, n_generated) and n_generated == l; the waits
    follow Lindley on the measured services; one capture of the decode
    step across all budgets; flash, slot decode and the FFN launched,
    slot decode once a layer a step; at least one re-solve. Prints the
    LatencyCalibrator's (t0_k, c_k) for each identified task beside
    the calibration phase's fit from the same process."""
    from repro_torch.core import Problem, ServerParams, paper_problem
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.obs import graph_hooks
    from repro_torch.queueing_sim import Segment, generate_drift_trace
    from repro_torch.serving import DecodeEngine, ReplayConfig, ReplayHarness

    paper = paper_problem()
    prob = Problem(tasks=paper.tasks, server=ServerParams(
        ENGINE_LAM, paper.server.alpha, float(ENGINE_L_MAX)))
    engine = DecodeEngine(cfg, params, cache_capacity=2048, chunk=16)
    decodes = []                         # (budget, n_generated, n_reasoning)
    generate = engine.generate

    def recorded(prompts, budgets, **kw):
        res = generate(prompts, budgets, **kw)
        decodes.append((int(budgets[0]), int(res["n_generated"][0]),
                        int(res["n_reasoning"][0])))
        return res
    engine.generate = recorded
    trace = generate_drift_trace(
        prob.tasks, [Segment(ENGINE_QUERIES, ENGINE_LAM)], seed=41,
        prompt_len_range=(ENGINE_PROMPT, ENGINE_PROMPT))
    h = ReplayHarness(prob, ReplayConfig(block_size=8, l_init=64,
                                         explore_frac=0.5, min_services=8),
                      engine=engine, device=dev)
    calls = _timed_resolves(h.controller)
    torch.cuda.synchronize()
    graph_hooks.reset()
    reset_launches()
    t0 = time.perf_counter()
    res = h.run_engine(trace, prompt_len=ENGINE_PROMPT, max_extra_tokens=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    graph = graph_stats("engine.chunk", engine.chunk)
    engine.generate = generate
    start = res.arrivals + res.waits
    finish = start + res.services
    lindley = bool(start[0] == res.arrivals[0] and np.allclose(
        start[1:], np.maximum(res.arrivals[1:], finish[:-1]), rtol=0,
        atol=1e-9))
    est = res.estimator_state
    fit = calibration["card_fit"]["latency"]
    learned = [{"task": prob.tasks.names[k], "t0_s": est["t0"][k],
                "c_s_per_token": est["c"][k],
                "n": int(np.sum(res.types == k))}
               for k in range(prob.tasks.n_tasks) if est["identified"][k]]
    out = {"phase": "replay_engine", "arch": cfg.arch_id,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "queries": ENGINE_QUERIES,
           "lam": ENGINE_LAM, "l_max": ENGINE_L_MAX,
           "prompt_len": ENGINE_PROMPT,
           "engine": "DecodeEngine(cache_capacity=2048, chunk=16)",
           "wall_s": wall, "n_resolves": res.n_resolves,
           "resolve_card": _resolve_stats(calls),
           "block_budgets": [b.budgets.tolist() for b in res.blocks],
           "budgets": res.budgets.tolist(),
           "services_s": res.services.tolist(),
           "waits_s": res.waits.tolist(),
           "decodes": len(decodes), "lindley": lindley,
           "learned_latency": learned,
           "calibration_fit": {"t0_s": fit["t0_s"],
                               "c_s_per_token": fit["c_s_per_token"],
                               "from": "calibration phase, same process"},
           "estimator": est, "measured": res.measured(),
           "graph": graph, "launches": launches}
    print(json.dumps(out), flush=True)
    check(len(decodes) == ENGINE_QUERIES + 1,
          f"replay_engine: {len(decodes)} decodes for {ENGINE_QUERIES} "
          "requests and the warm-up")
    for l, n_gen, n_reason in decodes:
        check(n_reason == min(l, n_gen) and n_gen == l,
              f"replay_engine: budget {l}, {n_gen} generated, {n_reason} "
              "reasoning")
    check(lindley, "replay_engine: the waits break the Lindley recursion")
    check(graph["captures"] == 1,
          f"replay_engine: decode graph captured {graph['captures']} times")
    check_dense_launches(cfg, launches, "replay_engine")
    n = decode_launches_expected(cfg, graph["steps"])["decode_attention"]
    check(launches.get("decode_attention", 0) == n,
          f"replay_engine: decode_attention launched "
          f"{launches.get('decode_attention', 0)} times in {graph['steps']} "
          f"steps, expected {n}")
    check(res.n_resolves >= 1, "replay_engine: no re-solve ran")
    return out


def prefix_generate_phase(dev, cfg, params) -> dict:
    """``DecodeEngine.generate`` with the stub frontend's prefix: two rows
    of ``n_prefix_embeds`` embeddings in front of 37-token prompts
    (budgets PREFIX_BUDGETS, 8 answer tokens) in a cache of prefix +
    prompt + 64 slots, decoding from position P + 37. The replayed graph
    (first call: its capture; second: replays only) and the eager
    per-token loop: tokens equal, exact budgets; the first call's
    launches exact (flash once a layer for the prefill, slot decode once
    a layer a step, the FFN once a layer a step and prefill for a SwiGLU
    model, never for a GELU one); decode tokens/s and ms a step against
    the weights' floor (their bytes at 3.35 TB/s)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.obs import graph_hooks
    from repro_torch.serving import DecodeEngine
    from repro_torch.train.tree import tree_leaves

    B = len(PREFIX_BUDGETS)
    prefix = stub_prefix(dev, cfg, B, seed=1)
    P = prefix.shape[1]
    prompts = (np.arange(B * PREFIX_PROMPT).reshape(B, PREFIX_PROMPT) % 97
               + 1).astype(np.int32)
    extra, chunk = 8, 16
    engine = DecodeEngine(cfg, params, cache_capacity=P + PREFIX_PROMPT + 64,
                          chunk=chunk)
    prefill_s = [0.0]
    prefill = engine.prefill

    def timed_prefill(*args, **kwargs):
        t0 = time.perf_counter()
        out = prefill(*args, **kwargs)
        torch.cuda.synchronize()
        prefill_s[0] += time.perf_counter() - t0
        return out
    engine.prefill = timed_prefill
    runs = {}
    graph_hooks.reset()
    for name, use_scan in (("graph_capture", True), ("graph", True),
                           ("eager_loop", False)):
        if name == "graph":
            graph_hooks.reset()
        reset_launches()
        prefill_s[0] = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.generate(prompts, list(PREFIX_BUDGETS),
                              max_extra_tokens=extra, prefix_embeds=prefix,
                              use_scan=use_scan)
        wall = time.perf_counter() - t0
        n = int(res["n_generated"].sum())
        steps = (graph_stats("engine.chunk", chunk)["steps"] if use_scan
                 else int(res["n_generated"].max()) - 1)
        runs[name] = {"wall_s": wall, "prefill_s": prefill_s[0],
                      "decode_s": wall - prefill_s[0], "steps": steps,
                      "decode_tokens_per_s": n / (wall - prefill_s[0]),
                      "decode_ms_per_step": (wall - prefill_s[0]) * 1e3
                      / max(steps, 1),
                      "launches": dict(LAUNCHES), "res": res}
    engine.prefill = prefill
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    floor_ms = weights / HBM_BYTES_PER_S * 1e3
    first = runs["graph_capture"]
    graph = graph_stats("engine.chunk", chunk)
    expected = {"flash_attention": cfg.n_layers,
                **decode_launches_expected(cfg, first["steps"]),
                "fused_ffn": (cfg.n_layers * (first["steps"] + 1)
                              if cfg.gated_mlp else 0)}
    tokens = [r.pop("res") for r in runs.values()]
    out = {"phase": "prefix_generate", "arch": cfg.arch_id,
           "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "prefix": list(prefix.shape), "prompt_len": PREFIX_PROMPT,
           "budgets": list(PREFIX_BUDGETS), "max_extra_tokens": extra,
           "cache_capacity": engine.capacity,
           "weights_gb": weights / 1e9, "weights_floor_ms_per_step": floor_ms,
           "graph_step_over_floor": runs["graph"]["decode_ms_per_step"]
           / floor_ms, "runs": runs, "graph_replays_only": graph,
           "launches_expected": expected,
           "n_generated": tokens[0]["n_generated"].tolist(),
           "tokens_equal": all(np.array_equal(t["tokens"],
                                              tokens[0]["tokens"])
                               for t in tokens)}
    print(json.dumps(out))
    check(out["tokens_equal"], f"{cfg.arch_id} prefix generate: graph and "
          f"eager tokens differ")
    check(out["n_generated"] == [b + extra for b in PREFIX_BUDGETS],
          f"{cfg.arch_id} prefix generate: {out['n_generated']} tokens")
    for name, n in expected.items():
        check(first["launches"].get(name, 0) == n,
              f"{cfg.arch_id} prefix generate: {name} launched "
              f"{first['launches'].get(name, 0)} times, expected {n}")
    check(graph["captures"] == 0 and graph["host_reads_per_chunk"] == 1,
          f"{cfg.arch_id} prefix generate: the second call {graph}")
    return out


TRAIN_ARGS = ["--arch", "olmo-1b", "--steps", "30", "--batch", "8",
              "--seq", "64", "--lr", "3e-3", "--log-every", "5"]
TRAIN_PEAK_FLOPS = 989e12     # bf16 dense tensor-core peak, H100 SXM
RESUME_RTOL = 1e-6


def train_phase(dev) -> dict:
    """Training on the card. (1) ``repro_torch.launch.train.main`` on
    full-width olmo-1b in bf16 (batch 8 x 64 tokens, 30 steps, lr 3e-3):
    every loss finite, the mean of the last 5 below the first 5's, no
    kernel launched (the trainer runs the reference math, as the JAX
    package trains through jnp: no Pallas kernel there has a VJP); median
    step ms, tokens/s, peak memory and the model-FLOP share 6 N tokens /
    (step time x 989 TFLOP/s). (2) On reduced olmo-1b: 4 steps, a
    checkpoint, a restore into a fresh state, 4 more, against 8 steps
    uninterrupted, as the card runs by default and under PyTorch's
    deterministic algorithms: losses within 1e-6 relative, whether
    bitwise. (3) A
    kernel called on a CUDA tensor that requires grad raises."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.kernels import (LAUNCHES, flash_attention, fused_ffn,
                                     reset_launches)
    from repro_torch.launch import train as train_launch
    from repro_torch.models import reduced
    from repro_torch import train
    from repro_torch.train.tree import tree_leaves

    cfg = get_config("olmo-1b")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    log = train_launch.main(TRAIN_ARGS + ["--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launched = {k: v for k, v in LAUNCHES.items() if v}
    losses = log["loss"]
    step_s = statistics.median(log["step_s"][1:])
    tokens = 8 * 64
    out = {"phase": "train", "arch": cfg.arch_id, "args": TRAIN_ARGS,
           "dtype": cfg.dtype, "params": cfg.param_count(), "wall_s": wall,
           "first_step_s": log["step_s"][0],
           "median_step_ms": step_s * 1e3,
           "tokens_per_s": tokens / step_s, "peak_memory_gb": peak_gb,
           "model_flop_share": 6 * cfg.param_count() * tokens
           / (step_s * TRAIN_PEAK_FLOPS),
           "loss": losses, "grad_norm": log["grad_norm"],
           "loss_first5_mean": float(np.mean(losses[:5])),
           "loss_last5_mean": float(np.mean(losses[-5:])),
           "kernel_launches": launched}
    print(json.dumps(out))
    check(bool(np.isfinite(losses).all()), "train: a loss is not finite")
    check(out["loss_last5_mean"] < out["loss_first5_mean"],
          f"train: loss did not fall ({out['loss_first5_mean']} -> "
          f"{out['loss_last5_mean']})")
    check(not launched, f"train: kernels launched {launched}")
    out["step_profile"] = train_step_profile(dev, cfg)
    print(json.dumps({"phase": "train_step_profile", "arch": cfg.arch_id,
                      **out["step_profile"]}))

    small = reduced(cfg)
    data = SyntheticTokens(DataConfig(vocab_size=small.vocab_size,
                                      seq_len=32, batch_size=4))
    step = train.make_train_step(small, train.AdamWConfig(
        lr=3e-3, warmup_steps=5, total_steps=8))
    ck = ROOT / "build" / "chip_smoke_ckpt"

    def resume_check() -> dict:
        state = train.init_train_state(small, seed=0, device=dev)
        straight, resumed = [], []
        s = state
        for i in range(8):
            s, m = step(s, {"tokens": data.batch(i)["tokens"]})
            straight.append(float(m["loss"]))
        r = state
        for i in range(4):
            r, m = step(r, {"tokens": data.batch(i)["tokens"]})
            resumed.append(float(m["loss"]))
        train.save_checkpoint(str(ck), r, step=4)
        r = train.restore_checkpoint(str(ck), train.init_train_state(
            small, seed=1, device=dev))
        shutil.rmtree(ck)
        for i in range(4, 8):
            r, m = step(r, {"tokens": data.batch(i)["tokens"]})
            resumed.append(float(m["loss"]))
        return {"losses": resumed, "uninterrupted": straight,
                "max_rel_diff": max(abs(a - b) / abs(b)
                                    for a, b in zip(resumed, straight)),
                "bitwise": resumed == straight and all(
                    torch.equal(a, b) for a, b in
                    zip(tree_leaves(s), tree_leaves(r)))}

    # as the card runs by default (the embedding's backward accumulates
    # through atomics), then with PyTorch's deterministic algorithms,
    # where a lossless checkpoint leaves the resumed run bitwise
    resume = {"arch": small.arch_id, "steps": "4 + save + restore + 4 "
              "against 8", "tol": RESUME_RTOL, "default": resume_check()}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        resume["deterministic_algorithms"] = resume_check()
    finally:
        torch.use_deterministic_algorithms(False)
    rel = max(resume[k]["max_rel_diff"]
              for k in ("default", "deterministic_algorithms"))
    out["resume"] = resume

    guard = {}
    x = torch.randn(1, 4, 64, device=dev, requires_grad=True)
    w, wd = torch.randn(1, 64, 128, device=dev), torch.randn(1, 128, 64,
                                                             device=dev)
    q = torch.randn(1, 2, 1, 8, 64, device=dev, requires_grad=True)
    kv = torch.randn(1, 2, 8, 64, device=dev)
    for name, call in (("fused_ffn", lambda: fused_ffn.fused_ffn(
            x, w, w, wd)), ("flash_attention",
                            lambda: flash_attention.flash_attention(
                                q, kv, kv))):
        try:
            call()
            guard[name] = "no error"
        except RuntimeError as e:
            guard[name] = str(e)
    out["grad_guard"] = guard
    print(json.dumps({"phase": "train_resume_and_guard",
                      "resume": out["resume"], "grad_guard": guard}))
    check(rel <= RESUME_RTOL, f"train resume: losses {rel} apart")
    check(all("forward-only" in v for v in guard.values()),
          f"train: a kernel took an input that requires grad {guard}")
    return out


def train_step_profile(dev, cfg, steps: int = 3) -> dict:
    """Where a full-width train step's time goes: ``steps`` steps of
    ``TRAIN_ARGS``' batch (after two warm ones), host wall time a step
    against the device time of the kernels the profiler saw, the largest
    items."""
    from repro_torch import train
    from repro_torch.data import DataConfig, SyntheticTokens

    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                      batch_size=8))
    step = train.make_train_step(cfg, train.AdamWConfig(
        lr=3e-3, warmup_steps=5, total_steps=30))
    box = {"state": train.init_train_state(cfg, seed=0, device=dev), "i": 0}

    def run():
        box["state"], _ = step(box["state"],
                               {"tokens": data.batch(box["i"])["tokens"]})
        box["i"] += 1
    for _ in range(2):
        run()
    out = profile_steps(run, steps, steps)
    del box
    return out


def vlm_audio_phases(dev, by_path: dict, free) -> dict:
    """The VLM and audio ids. llava-next-mistral-7b: the f32 check at
    LLAVA_F32_LAYERS of 32 layers behind the 1152-row prefix, then bf16 at
    full width and depth: the prefix generate (B 2, a [2, 1152, 4096]
    prefix) and the 8-query serve through LLMServer (text-only, as the
    JAX package's server). musicgen-medium: the f32 check at full depth
    behind its 64 rows, the bf16 prefix generate and serve, and the slot
    and paged continuous serves (8 slots, blocks of 16; text-only). Each
    model freed before the next; each sub-phase's seconds."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    seconds = {}
    for arch, f32_layers in (("llava-next-mistral-7b", LLAVA_F32_LAYERS),
                             ("musicgen-medium", None)):
        t = time.perf_counter()
        cfg = get_config(arch)
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    n_layers=f32_layers or cfg.n_layers)
        params32 = init_params(cfg32, seed=0, device=dev)
        model_phase(dev, cfg32, params32)
        del params32
        free()
        seconds[f"{arch} model"] = time.perf_counter() - t
        t = time.perf_counter()
        params = init_params(cfg, seed=0, device=dev)
        by_path[f"{arch} prefix generate"] = prefix_generate_phase(
            dev, cfg, params)["runs"]["graph_capture"]["launches"]
        seconds[f"{arch} prefix generate"] = time.perf_counter() - t
        t = time.perf_counter()
        kernels = ("flash_attention", "decode_attention") + (
            ("fused_ffn",) if cfg.gated_mlp else ())
        by_path[f"{arch} serve"] = serve_phase(dev, arch, kernels,
                                               params=params)["launches"]
        free()
        seconds[f"{arch} serve"] = time.perf_counter() - t
        if arch == "musicgen-medium":
            for mode in ("slot", "paged"):
                t = time.perf_counter()
                by_path[f"{arch} continuous serve ({mode})"] = \
                    continuous_serve_phase(dev, cfg, params,
                                           paged=mode == "paged")["launches"]
                free()
                seconds[f"{arch} continuous {mode}"] = \
                    time.perf_counter() - t
        del params
        free()
    print(json.dumps({"phase": "vlm_audio_seconds", **seconds}))
    return seconds


def dist_roofline(cfg, shape) -> dict:
    """``roofline.analysis`` for one card's share of a step, counted on
    the reference math at the same shapes (meta stand-ins on the host,
    nothing allocated)."""
    from repro_torch.launch import shapes as lshapes
    from repro_torch.launch import steps as lsteps
    from repro_torch.roofline import analysis
    params, _ = lshapes.params_specs_for(cfg, None)
    spec = lshapes.input_specs(cfg, shape, None)
    if shape.kind == "prefill":
        res = analysis.count_step(lsteps.make_prefill_step(cfg, True),
                                  (params, spec["tokens"]))
    else:
        res = analysis.count_step(lsteps.make_serve_step(cfg, True),
                                  (params, spec["token"], spec["cache"]),
                                  spec["cache"])
    return analysis.analyze(res["cost"], res["collectives"], cfg, shape,
                            1).as_dict()


def _rows(logits: torch.Tensor) -> torch.Tensor:
    """A step's last-position logits as f32 [rows, vocab]."""
    return logits.float().reshape(logits.shape[0], -1)


def _top1_hold(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Kernel-path logits against the reference path's: each row's top-1
    token, and max |delta| (bf16 at full depth, held at DIST_HOLD_TOL)
    beside the largest |logit|; the reference's top-1 margin of each
    row (its first logit less its second), the rows whose top-1 differs,
    and each row's reference logit of the kernel path's top-1 token below
    the reference's top one (0 where they agree; DIST_TIE_MARGIN bounds a
    flipped row's under the tie rule)."""
    got, want = _rows(got), _rows(want)
    delta = float((got - want).abs().max())
    top2 = want.topk(2, dim=-1).values
    top1 = got.argmax(-1)
    flipped = torch.nonzero(top1 != want.argmax(-1)).flatten()
    gap = top2[:, 0] - want.gather(1, top1[:, None])[:, 0]
    return {"top1_equal": not flipped.numel(),
            "rows": got.shape[0],
            "max_abs_delta": delta,
            "max_abs_logit": float(want.abs().max()),
            "tol": DIST_HOLD_TOL,
            "ref_top1_margin": (top2[:, 0] - top2[:, 1]).tolist(),
            "flipped_rows": flipped.tolist(),
            "ref_gap_of_kernel_top1": gap.tolist(),
            "finite": bool(torch.isfinite(got).all())}


def _attn_cache(cache):
    """The decode cache's attention part whose ``length`` is the position:
    the stack's own, or the hybrid's shared block's (the recurrent caches
    keep theirs on the host); the recurrent stack's, whose length is a
    host int."""
    return cache["layers"] if "layers" in cache else cache["shared"]


def _recurrent_leaves(cache) -> list:
    """The hybrid's recurrent state tensors (conv tails, SSD states), which
    a decode step updates in place."""
    return [t for key in ("grouped", "remainder") if cache.get(key)
            is not None for t in cache[key] if isinstance(t, torch.Tensor)]


def _f32(cfg, params) -> tuple:
    """The config and f32 copies of the weights for the f32 witness."""
    from repro_torch.train.tree import tree_leaves, tree_unflatten
    return (dataclasses.replace(cfg, dtype="float32"),
            tree_unflatten(params, [t.float() for t in tree_leaves(params)]))


def _witness(got, want, exact) -> dict:
    """The bf16 kernel path's (``got``) and bf16 reference path's
    (``want``) logits against the reference path's on f32 weights
    (``exact``, the JAX models' math in f32 end to end): how far each lies
    from it, the f32 top-1 margin of each row and the rows whose top-1
    differs from the f32 one, so a top-1 flip reads as bf16 rounding or as
    the kernel's own error."""
    got, want, exact = _rows(got), _rows(want), _rows(exact)
    top2 = exact.topk(2, dim=-1).values
    first = exact.argmax(-1)
    return {"kernel_vs_f32_ref": float((got - exact).abs().max()),
            "reference_vs_f32_ref": float((want - exact).abs().max()),
            "f32_ref_top1_margin": (top2[:, 0] - top2[:, 1]).tolist(),
            "kernel_top1_off_f32_rows": torch.nonzero(
                got.argmax(-1) != first).flatten().tolist(),
            "reference_top1_off_f32_rows": torch.nonzero(
                want.argmax(-1) != first).flatten().tolist()}


def _dist_prefill(dev, cfg, params, shape) -> dict:
    """One card's share of prefill_32k through launch/steps.py on the
    kernels: the hold at the prompt's first DIST_HOLD_S tokens (kernel
    path against the reference path, and both against the reference path
    on f32 weights, ``_witness``), then DIST_PREFILL_RUNS timed runs at
    full S (finite only), launches counted over the last."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps as lsteps
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (shape.batch, shape.seq),
                         generator=g).to(dev)
    step, ref = lsteps.make_prefill_step(cfg), \
        lsteps.make_prefill_step(cfg, force_ref=True)
    with torch.no_grad():
        got, cache = step(params, toks[:, :DIST_HOLD_S])
        del cache
        want, cache = ref(params, toks[:, :DIST_HOLD_S])
        del cache
        hold = _top1_hold(got, want)
        cfg32, p32 = _f32(cfg, params)
        exact, cache = lsteps.make_prefill_step(cfg32, force_ref=True)(
            p32, toks[:, :DIST_HOLD_S])
        del cache, p32
        hold["f32_witness"] = _witness(got, want, exact)
        times = []
        for _ in range(DIST_PREFILL_RUNS):
            gc.collect()
            torch.cuda.empty_cache()
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = step(params, toks)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches = dict(LAUNCHES)
            finite = bool(torch.isfinite(logits).all())
            check(finite, f"{cfg.arch_id} prefill_32k: non-finite logits "
                          "at full S")
            check(int(_attn_cache(cache).length) == shape.seq,
                  f"{cfg.arch_id} prefill_32k: cache length")
            del logits, cache
    return {"ms": statistics.median(times) * 1e3,
            "ms_runs": [t * 1e3 for t in times], "launches": launches,
            "hold": {**hold, "tokens": DIST_HOLD_S}, "finite_full_s": finite}


def _dist_decode(dev, cfg, params, shape) -> dict:
    """One card's share of decode_32k / long_500k: a cache of shape.seq
    positions (a ring of the window under long_500k) filled from a seeded
    generator (K, V and, for the hybrid, the Mamba2 layers' conv tails and
    SSD states), its length DIST_STEPS short of shape.seq, then
    DIST_STEPS greedy serve steps through launch/steps.py on the kernels.
    The first step's logits are held against the reference path's on the
    same cache (the reference step runs first; the position is rewound
    and the recurrent state restored, and the kernel step rewrites the
    same slot in every layer), and both against the reference path on
    f32 weights (``_decode_witness``)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps as lsteps
    from repro_torch.models import init_decode_cache
    cache = init_decode_cache(cfg, shape.batch, shape.seq, dev)
    g = torch.Generator(device=dev).manual_seed(DIST_CACHE_SEED)
    kv = _attn_cache(cache)
    for leaf in (kv.k, kv.v, *_recurrent_leaves(cache)):
        for layer in range(leaf.shape[0]):
            leaf[layer].normal_(generator=g)
    leaf = None          # a loop variable would keep a K/V buffer alive
    g = torch.Generator(device=dev).manual_seed(DIST_CACHE_SEED)
    check(torch.equal(torch.empty_like(kv.k[0]).normal_(generator=g),
                      kv.k[0]), "the decode cache's draws do not replay")
    start = shape.seq - DIST_STEPS
    kv.length.fill_(start)
    recurrent = [t.clone() for t in _recurrent_leaves(cache)]
    tok = torch.randint(0, cfg.vocab_size, (shape.batch, 1),
                        generator=torch.Generator().manual_seed(2)) \
        .to(dev, torch.int32)
    step, ref = lsteps.make_serve_step(cfg), \
        lsteps.make_serve_step(cfg, force_ref=True)
    with torch.no_grad():
        want, cache = ref(params, tok, cache)
        _attn_cache(cache).length.fill_(start)
        for leaf, saved in zip(_recurrent_leaves(cache), recurrent):
            leaf.copy_(saved)
        leaf = saved = None
        reset_launches()
        times, first, tok0 = [], None, tok
        for _ in range(DIST_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = step(params, tok, cache)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if first is None:
                first = logits
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        launches = dict(LAUNCHES)
        check(int(_attn_cache(cache).length) == shape.seq,
              f"{cfg.arch_id} {shape.name}: cache length after the steps")
        check(bool(torch.isfinite(logits).all()),
              f"{cfg.arch_id} {shape.name}: non-finite logits")
        hold = _top1_hold(first, want)
        # the cache freed (its bf16 K/V beside the f32 weights would not
        # fit): the witness draws its K/V again
        del cache, kv, logits
        gc.collect()
        torch.cuda.empty_cache()
        hold["f32_witness"] = _decode_witness(
            dev, cfg, params, shape, tok0, recurrent, start, first, want)
        del recurrent
    return {"ms": statistics.median(times) * 1e3,
            "ms_min": min(times) * 1e3, "launches": launches,
            "hold": hold, "capacity": shape.seq if cfg.sliding_window is None
            else min(shape.seq, cfg.sliding_window)}


def _decode_witness(dev, cfg, params, shape, tok, recurrent, start: int,
                    got, want) -> dict:
    """``_witness`` of a decode step: the reference step on f32 weights
    over the state the first step found (the attention cache's K/V drawn
    again from DIST_CACHE_SEED, the recurrent leaves from ``recurrent``,
    the position ``start``), DIST_WITNESS_ROWS rows at a time in caches of
    their own in f32 (the draws are bf16, exact in f32)."""
    from repro_torch.launch import steps as lsteps
    cfg32, p32 = _f32(cfg, params)
    ref = lsteps.make_serve_step(cfg32, force_ref=True)
    exact = []
    for r0 in range(0, shape.batch, DIST_WITNESS_ROWS):
        n = min(DIST_WITNESS_ROWS, shape.batch - r0)
        cache = _rows_cache(dev, cfg, cfg32, shape, recurrent, start, r0, n)
        logits, cache = ref(p32, tok[r0:r0 + n], cache)
        exact.append(logits.float())
        del cache, logits
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    return _witness(got, want, torch.cat(exact))


def _rows_cache(dev, cfg, cfg32, shape, recurrent, start: int, r0: int,
                n: int) -> dict:
    """A decode cache in ``cfg32``'s dtype holding rows r0 .. r0 + n - 1
    of the state ``_decode_witness`` reads, at position ``start``: each
    layer's K, then V, drawn again at ``cfg``'s full batch and dtype in
    ``_dist_decode``'s order."""
    from repro_torch.models import init_decode_cache
    cache = init_decode_cache(cfg32, n, shape.seq, dev)
    kv = _attn_cache(cache)
    g = torch.Generator(device=dev).manual_seed(DIST_CACHE_SEED)
    draw = torch.empty((shape.batch,) + kv.k.shape[2:], dtype=cfg.tdtype,
                       device=dev)
    for buf in (kv.k, kv.v):
        for layer in range(buf.shape[0]):
            buf[layer].copy_(draw.normal_(generator=g)[r0:r0 + n])
    kv.length.fill_(start)
    for leaf, full in zip(_recurrent_leaves(cache), recurrent):
        axis = [i for i, (a, b) in enumerate(zip(full.shape, leaf.shape))
                if a != b]
        leaf.copy_(full.narrow(axis[0], r0, n) if axis else full)
    return cache


def train_state_delta(got, want, p0, lr: float, opt) -> dict:
    """A sharded train step's new state against the unsharded one (here
    and on the 2x2 gloo mesh of tests/test_torch_sharding.py): m and v,
    max |d| over each leaf's norm; the parameters, max |d| over 2 lr (a
    gradient element near 0 flips the sign of its first AdamW step on a
    rounding); and the sharded parameters against the first AdamW step
    from ``p0`` recomputed on the sharded m and v, max |d| over 1e-2 lr +
    1e-6 of each leaf's max |p0|."""
    from repro_torch.train.tree import tree_leaves

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t
    out = {"m": 0.0, "v": 0.0, "p_2lr": 0.0, "p_own": 0.0}
    for key in ("m", "v"):
        for a, b in zip(tree_leaves(getattr(got.opt, key)),
                        tree_leaves(getattr(want.opt, key))):
            d = float((full(a) - b).abs().max())
            out[key] = max(out[key], d / max(float(b.norm()), 1e-30))
    one = torch.ones((), device=tree_leaves(p0)[0].device)
    b1c, b2c = 1.0 - opt.beta1 ** one, 1.0 - opt.beta2 ** one
    for a, b, p, m, v in zip(*(tree_leaves(t) for t in (
            got.params, want.params, p0, got.opt.m, got.opt.v))):
        a, m, v = full(a).float(), full(m), full(v)
        out["p_2lr"] = max(out["p_2lr"], float(
            (a - b.float()).abs().max()) / (2 * lr))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + opt.eps)
        if p.dim() >= 2:
            delta = delta + opt.weight_decay * p.float()
        own = (p.float() - lr * delta).to(p.dtype).float()
        out["p_own"] = max(out["p_own"], float((a - own).abs().max())
                           / (1e-2 * lr + 1e-6 * float(
                               p.float().abs().max())))
    return out


def sharded_check(dev) -> dict:
    """The sharded path on a 1x1 NCCL mesh: qwen3-0.6b at full width in
    f32 at DIST_SHARDED_LAYERS of its 28 layers, its parameters, tokens
    and decode cache DTensors. The sharded train step's loss, gradient
    norm and new state (``train_state_delta``) and one sharded decode
    step's logits against the same steps unsharded, on the reference path
    (the decode on the initial parameters: after an AdamW step a gradient
    element near 0 moves its parameter by up to 2 lr on a rounding); the
    new state in the old state's placements; no kernel launched (no
    kernel is sharded; a wrapper handed a DTensor raises)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps as lsteps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_decode_cache, init_params
    from repro_torch.sharding import partition as part
    from repro_torch.sharding.context import use_mesh
    from repro_torch.train import AdamWConfig, TrainState, init_opt_state
    from repro_torch.train.tree import tree_leaves
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), dtype="float32",
                              n_layers=DIST_SHARDED_LAYERS)
    params = init_params(cfg, seed=0, device=dev)
    B = 2
    toks = torch.randint(0, cfg.vocab_size, (B, 65),
                         generator=torch.Generator().manual_seed(3)).to(dev)
    tok = toks[:, :1].to(torch.int32)
    train = lsteps.make_train_step_fn(cfg)
    serve = lsteps.make_serve_step(cfg, force_ref=True)
    st, m = train(TrainState(params, init_opt_state(params)),
                  {"tokens": toks})
    with torch.no_grad():
        want, _ = serve(params, tok, init_decode_cache(cfg, B, 128, dev))
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_debug_mesh(1, 1)
        reset_launches()
        with use_mesh(mesh):
            dp = part.distribute(params, part.param_placements(
                cfg, params, mesh), mesh)
            tok_pl = part.placements(part.token_spec(mesh, B), mesh)
            state = TrainState(dp, init_opt_state(dp))
            dst, dm = train(state, {"tokens": part.distribute(toks, tok_pl,
                                                              mesh)})
            kept = all(a.placements == b.placements for a, b in
                       zip(tree_leaves(dst), tree_leaves(state))
                       if hasattr(b, "placements"))
            cache = init_decode_cache(cfg, B, 128, dev)
            dc = part.distribute(cache, part.cache_placements(
                cfg, cache, mesh, B), mesh)
            with torch.no_grad():
                got, _ = serve(dp, part.distribute(tok, tok_pl, mesh), dc)
            got = got.full_tensor()
            state_d = train_state_delta(dst, st, params, float(m["lr"]),
                                        AdamWConfig())
            loss = float(dm["loss"].full_tensor())
            gnorm = float(dm["grad_norm"].full_tensor())
            n_dtensor = sum(hasattr(t, "placements") for t in
                            dp["blocks"]["attn"].values())
        launches = sum(LAUNCHES.values())
    finally:
        dist.destroy_process_group()
    out = {"mesh": "1x1 nccl", "layers": DIST_SHARDED_LAYERS,
           "loss": loss, "loss_unsharded": float(m["loss"]),
           "loss_delta": abs(loss - float(m["loss"])),
           "grad_norm_rel_delta": abs(gnorm - float(m["grad_norm"]))
           / float(m["grad_norm"]), "placements_kept": kept,
           "logits_max_abs_delta": float((got - want).abs().max()),
           "dtensor_attn_leaves": n_dtensor, "kernel_launches": launches,
           "state": state_d, "tol": DIST_SHARDED_TOL}
    print(json.dumps({"phase": "distribution_sharded", **out}))
    check(out["loss_delta"] <= DIST_SHARDED_TOL,
          f"sharded train loss off by {out['loss_delta']}")
    check(out["logits_max_abs_delta"] <= DIST_SHARDED_TOL,
          f"sharded decode logits off by {out['logits_max_abs_delta']}")
    check(out["grad_norm_rel_delta"] <= DIST_SHARDED_TOL,
          f"sharded gradient norm off by {out['grad_norm_rel_delta']}")
    check(kept, "the sharded train step moved the state's placements")
    check(state_d["m"] <= DIST_STATE_TOL and state_d["v"] <= DIST_STATE_TOL,
          f"sharded train step's moments off: {state_d}")
    check(state_d["p_2lr"] <= 1.0 + 1e-6 and state_d["p_own"] <= 1.0,
          f"sharded train step's parameters off: {state_d}")
    check(launches == 0, f"the sharded path launched {launches} kernels")
    check(n_dtensor > 0, "the sharded path held no DTensor")
    return out


def distribution_phase(dev, cfg8, params8, smi: str) -> dict:
    """qwen3-8b's steps at the pod mesh's per-device share (DIST_BATCH) at
    full width in bf16 through launch/steps.py on the kernels, each beside
    its roofline (counted on the reference math at the same shapes), then
    the sharded path on a 1x1 NCCL mesh (``sharded_check``). Returns the
    launches of each step for the kernels' summary."""
    from repro_torch.launch import shapes as lshapes
    check(lshapes.SHAPES["decode_32k"].seq == DIST_S
          and lshapes.LONG_CONTEXT_WINDOW == DIST_WINDOW,
          "the kernel cases' distribution shapes are not the steps'")
    launches = {}
    for name in DIST_BATCH:
        run = dist_step(dev, cfg8, params8, name, smi)
        for kernel in ("fused_ffn", "flash_attention"
                       if name == "prefill_32k" else "decode_attention"):
            check(run["launches"].get(kernel, 0) > 0,
                  f"qwen3-8b {name}: {kernel} not launched")
        launches[f"qwen3-8b {name}"] = run["launches"]
    sharded_check(dev)
    return launches


def dist_step(dev, cfg_base, params, name: str, smi: str,
              ties: bool = False) -> dict:
    """One step at the pod mesh's per-device share (DIST_BATCH) through
    launch/steps.py on the kernels (``_dist_prefill`` / ``_dist_decode``)
    beside its roofline (``dist_roofline``); prints its row, checks its
    hold (its f32 witness within DIST_WITNESS_FACTOR) and returns the run.
    ``ties``: the kernel path may rank first a token whose reference logit
    lies within DIST_TIE_MARGIN of the top one (DIST_TIE_REASON); without
    it every row's top-1 must be equal."""
    from repro_torch.launch import shapes as lshapes
    from repro_torch.roofline import analysis
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    shape = dataclasses.replace(lshapes.SHAPES[name],
                                batch=DIST_BATCH[name])
    cfg = lshapes.adapt_config(cfg_base, shape)
    roof = dist_roofline(cfg, shape)
    t_roof = time.perf_counter() - t
    run = (_dist_prefill(dev, cfg, params, shape)
           if shape.kind == "prefill" else
           _dist_decode(dev, cfg, params, shape))
    gc.collect()
    torch.cuda.empty_cache()
    s = run["ms"] / 1e3
    terms = {k: roof[k] for k in ("compute_s", "memory_s", "collective_s")}
    row = {"phase": "distribution", "arch": cfg.arch_id, "step": name,
           "batch": shape.batch, "seq": shape.seq,
           "window": cfg.sliding_window,
           "ms": run["ms"], "launches": run["launches"],
           "compute_s": roof["compute_s"], "memory_s": roof["memory_s"],
           "bottleneck": roof["bottleneck"],
           "flops_per_device": roof["flops_per_device"],
           "bytes_per_device": roof["bytes_per_device"],
           "roofline_share": max(terms.values()) / s,
           "mfu": analysis.model_flops(cfg, shape)
           / (s * analysis.PEAK_FLOPS_BF16),
           "hold": run["hold"], "card": smi,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "tie_rule": DIST_TIE_REASON if ties else None,
           "roofline_count_s": t_roof,
           "seconds": time.perf_counter() - t,
           **{k: v for k, v in run.items()
              if k not in ("ms", "launches", "hold")}}
    print(json.dumps(row))
    where = f"{cfg.arch_id} {name}"
    check(run["hold"]["finite"], f"{where}: non-finite logits")
    hold = run["hold"]
    check(hold["top1_equal"] or ties and max(hold["ref_gap_of_kernel_top1"])
          <= DIST_TIE_MARGIN,
          f"{where}: kernel path's top-1 differs from the reference's on "
          f"rows {hold['flipped_rows']} (reference gaps "
          f"{hold['ref_gap_of_kernel_top1']})")
    check(run["hold"]["max_abs_delta"] <= DIST_HOLD_TOL,
          f"{where}: kernel path's logits off the reference's by "
          f"{run['hold']['max_abs_delta']}")
    w = hold["f32_witness"]
    check(w["kernel_vs_f32_ref"] <= DIST_WITNESS_FACTOR
          * w["reference_vs_f32_ref"],
          f"{where}: kernel path {w['kernel_vs_f32_ref']} from the f32 "
          f"reference, over {DIST_WITNESS_FACTOR} x the bf16 reference "
          f"path's {w['reference_vs_f32_ref']}")
    return run


def scan_launches_expected(cfg, kind: str) -> dict:
    """A scan family's launches in one prefill (every layer's scan; the
    hybrid's flash and FFN once per shared-block application) or, for the
    hybrid, in DIST_STEPS decode steps (slot decode and the FFN once per
    shared-block application a step; the scans do not run)."""
    if cfg.backbone_kind == "rwkv6":
        return {"rwkv6_scan": cfg.n_layers}
    g = cfg.n_layers // cfg.attn_every
    if kind == "prefill":
        return {"ssd_scan": cfg.n_layers, "flash_attention": g,
                "fused_ffn": g}
    return {"decode_attention": g * DIST_STEPS, "fused_ffn": g * DIST_STEPS}


def scan_distribution_phase(dev, smi: str) -> dict:
    """The scan families' steps at the pod mesh's per-device share
    (DIST_SCAN_STEPS), full width and depth, bf16, random weights from
    seed 0, through launch/steps.py on the kernels, each beside its
    roofline and held as qwen3-8b's are (the reference path is the JAX
    models' chunked scan math); each kernel's launches exact. Run with
    qwen3-8b's weights freed: zamba2's decode_32k holds 48.9 GB of KV
    beside its 13 GB of weights. Returns the launches of each step."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    launches = {}
    for arch, names in DIST_SCAN_STEPS.items():
        cfg = get_config(arch)
        params = init_params(cfg, seed=0, device=dev)
        for name in names:
            run = dist_step(dev, cfg, params, name, smi, ties=True)
            want = scan_launches_expected(
                cfg, "prefill" if name == "prefill_32k" else "decode")
            got = {k: run["launches"].get(k, 0) for k in want}
            check(got == want and sum(run["launches"].values())
                  == sum(want.values()),
                  f"{arch} {name}: launches {run['launches']}, expected "
                  f"{want}")
            launches[f"{arch} {name}"] = run["launches"]
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return launches


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
    # no TPU kernel: the capacity dispatch's stable argsort and its ranks
    "moe_ranks": ("src/repro_torch/csrc/moe_ranks.cu",
                  "src/repro/models/moe.py:105"),
}


ONLY_GROUPS = ("kernels", "vlm_audio", "train", "distribution",
               "published_hybrid")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on "
                                 "one CUDA card (no arguments: every phase)")
    ap.add_argument("--only", default=None,
                    help="a development run of a comma-separated subset of "
                         f"{', '.join(ONLY_GROUPS)}, after the build; it "
                         "prints their lines and seconds, and neither the "
                         "kernels' summary nor the ok line")
    args = ap.parse_args(argv)
    only = None if args.only is None else set(args.only.split(","))
    if only is not None and not only <= set(ONLY_GROUPS):
        ap.error(f"--only takes {ONLY_GROUPS}")
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
    t_start = time.perf_counter()
    seconds = {}

    @contextlib.contextmanager
    def timed(name):
        """Each top-level phase's seconds, printed as it ends."""
        t = time.perf_counter()
        yield
        seconds[name] = time.perf_counter() - t
        print(json.dumps({"phase": "phase_seconds", "name": name,
                          "seconds": seconds[name],
                          "elapsed_s": time.perf_counter() - t_start}))

    with timed("build"):
        per_source = _build.build()
    print(json.dumps({"phase": "build", "seconds": seconds["build"],
                      "per_source_s": per_source}))

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    by_path = {}
    if only is not None:
        if "kernels" in only:
            flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
            with timed("kernel_cases"):
                kernel_cases(dev, flush)
            del flush
        if "vlm_audio" in only:
            with timed("vlm_audio"):
                vlm_audio_phases(dev, by_path, free)
        if "train" in only:
            with timed("train"):
                train_phase(dev)
        if "published_hybrid" in only:
            with timed("zamba2-7b-instruct"):
                by_path.update(published_hybrid_phase(dev))
                free()
        if "distribution" in only:
            with timed("distribution"):
                cfg8 = get_config("qwen3-8b")
                params8 = init_params(cfg8, seed=0, device=dev)
                by_path.update(distribution_phase(dev, cfg8, params8, smi))
                del params8
                free()
                by_path.update(scan_distribution_phase(dev, smi))
                free()
        print(json.dumps({"phase_seconds": seconds, "launches_by_path":
                          by_path,
                          "total_s": time.perf_counter() - t_start}))
        return 0

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    with timed("kernel_cases"):
        _, summary = kernel_cases(dev, flush)
    with timed("des"):
        des_lanes = des_phase(dev, flush)
    del flush

    def f32_model(arch, n_layers=None):
        cfg32 = dataclasses.replace(get_config(arch), dtype="float32")
        if n_layers is not None:
            cfg32 = dataclasses.replace(cfg32, n_layers=n_layers)
        return cfg32, init_params(cfg32, seed=0, device=dev)

    def slot_serve(arch):
        """``arch`` in bf16 at full width through the slot continuous
        engine; its launches."""
        cfg = get_config(arch)
        params = init_params(cfg, seed=0, device=dev)
        return continuous_serve_phase(dev, cfg, params,
                                      paged=False)["launches"]

    with timed("qwen3-0.6b model"):
        cfg32, params32 = f32_model("qwen3-0.6b")
        model_phase(dev, cfg32, params32)
        paged_model_phase(dev, cfg32, params32)
        int8_model_phase(dev, cfg32, params32)
        del params32
        free()

    attn_kernels = ("flash_attention", "decode_attention", "fused_ffn")
    with timed("qwen3-0.6b serves"):
        served = serve_phase(dev, "qwen3-0.6b", attn_kernels)
        free()
        served8 = serve_phase(dev, "qwen3-0.6b", attn_kernels,
                              kv_cache_dtype="int8")
        free()
    with timed("qwen3-0.6b batched"):
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
    by_path.update({
        "qwen3-0.6b serve": served["launches"],
        "qwen3-0.6b continuous serve": continuous["launches"],
        "qwen3-0.6b int8 serve": served8["launches"],
        "qwen3-0.6b int8 paged drain": drain8["paged"]["launches"],
        "qwen3-0.6b hooks serve": hooks["launches"]})
    for arch, kernels in (("rwkv6-1.6b", ("rwkv6_scan",)),
                          ("zamba2-7b", ("ssd_scan",) + attn_kernels)):
        with timed(arch):
            cfg32, params32 = f32_model(arch)
            model_phase(dev, cfg32, params32)
            del params32
            free()
            by_path[f"{arch} serve"] = serve_phase(dev, arch,
                                                   kernels)["launches"]
            free()
            by_path[f"{arch} continuous serve"] = slot_serve(arch)
            free()
            by_path[f"{arch} recurrent drain"] = recurrent_drain_phase(
                dev, arch)["launches"]
            free()
    with timed("zamba2-7b-instruct"):
        by_path.update(published_hybrid_phase(dev))
        free()
    # the other dense ids: LayerNorm without parameters (olmo-1b),
    # LayerNorm (stablelm-3b), LayerNorm, GELU MLP and a sliding window
    # (starcoder2-3b, also through the continuous engine)
    for arch in ("olmo-1b", "stablelm-3b", "starcoder2-3b"):
        with timed(arch):
            cfg32, params32 = f32_model(arch)
            model_phase(dev, cfg32, params32)
            if cfg32.sliding_window is not None:
                by_path[f"{arch} window check"] = window_phase(
                    dev, cfg32, params32)["launches"]
            del params32
            free()
            kernels = ("flash_attention", "decode_attention") + (
                ("fused_ffn",) if cfg32.gated_mlp else ())
            by_path[f"{arch} serve"] = serve_phase(dev, arch,
                                                   kernels)["launches"]
            free()
            if arch == "starcoder2-3b":
                by_path[f"{arch} continuous serve"] = slot_serve(arch)
                free()
    # the MoE ids: deepseek-moe-16b (the f32 check at DS_F32_LAYERS of its
    # 28 layers; bf16 at full depth through DecodeEngine, then the slot and
    # the paged continuous engine on the same weights) and
    # granite-moe-3b-a800m (the f32 check at full depth, the bf16 serve)
    for arch, f32_layers in (("deepseek-moe-16b", DS_F32_LAYERS),
                             ("granite-moe-3b-a800m", None)):
        moe_s = {}
        t_moe = time.perf_counter()
        with timed(arch):
            cfg32, params32 = f32_model(arch, n_layers=f32_layers)
            model_phase(dev, cfg32, params32)
            del params32
            free()
            moe_s["model"] = time.perf_counter() - t_moe
            cfg_m = get_config(arch)
            params_m = init_params(cfg_m, seed=0, device=dev)
            by_path[f"{arch} serve"] = serve_phase(
                dev, arch, attn_kernels, params=params_m)["launches"]
            free()
            moe_s["serve"] = time.perf_counter() - t_moe - sum(moe_s.values())
            if arch == "deepseek-moe-16b":
                for mode in ("slot", "paged"):
                    by_path[f"{arch} continuous serve ({mode})"] = \
                        continuous_serve_phase(
                            dev, cfg_m, params_m,
                            paged=mode == "paged")["launches"]
                    free()
                    moe_s[f"continuous_{mode}"] = (
                        time.perf_counter() - t_moe - sum(moe_s.values()))
            del params_m
            free()
        print(json.dumps({"phase": "moe_seconds", "arch": arch, **moe_s,
                          "total": time.perf_counter() - t_moe}))
    # the VLM and audio ids behind their stub frontends' prefixes, then
    # training: each model freed before the next
    with timed("vlm_audio"):
        vlm_audio_phases(dev, by_path, free)
    with timed("train"):
        train_phase(dev)
        free()
    with timed("qwen3-8b"):
        cfg32, params32 = f32_model("qwen3-8b",
                                    n_layers=QWEN3_8B_F32_LAYERS)
        model_phase(dev, cfg32, params32)
        paged_model_phase(dev, cfg32, params32)
        del params32
        free()
        # the paper's model at full width: its weights serve the
        # wall-clock serve, then the closed loop's engine lane, one init
        # for both
        cfg8 = get_config("qwen3-8b")
        params8 = init_params(cfg8, seed=0, device=dev)
        served_8b = serve_phase(dev, "qwen3-8b", attn_kernels, mode="wall",
                                params=params8)
        by_path["qwen3-8b serve"] = served_8b["launches"]
        free()
    with timed("calibration and replay engine"):
        calibration = calibration_phase(served_8b, occupancy)
        by_path["qwen3-8b replay engine"] = replay_engine_phase(
            dev, cfg8, params8, calibration)["launches"]
        free()
    with timed("distribution"):
        by_path.update(distribution_phase(dev, cfg8, params8, smi))
        del params8
        free()
        by_path.update(scan_distribution_phase(dev, smi))
        free()
    with timed("sweeps"):
        swept = sweeps_phase(dev)["launches"]
    with timed("replay"):
        replay_phase(dev)
        replay_drift_phase(dev)
    for row in des_lanes:
        if row["name"] in swept:
            row["launches_sweeps"] = swept[row["name"]]
    # each kernel's launches on the path that runs it: the slot kernels on
    # qwen3's DecodeEngine serve, the paged kernel on the continuous serve,
    # each scan on its family's serve, the pair ranks on deepseek-moe-16b's
    launches = {**served["launches"], "paged_decode_attention":
                continuous["launches"]["paged_decode_attention"],
                "rwkv6_scan": by_path["rwkv6-1.6b serve"]["rwkv6_scan"],
                "ssd_scan": by_path["zamba2-7b serve"]["ssd_scan"],
                "moe_ranks": by_path["deepseek-moe-16b serve"]["moe_ranks"]}

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
    print(json.dumps({"phase_seconds": seconds,
                      "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"des_lanes": des_lanes}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
