"""Queueing simulation validating the paper's M/G/1 analysis.

Counterpart of ``repro.queueing_sim``. Three simulator paths share one
workload model:

* ``mg1.simulate`` — scalar heapq event loop; the asserted reference path
  for every discipline (and the overflow fallback of the fast paths).
* ``batched`` — vectorized Lindley-recursion FIFO fast path (NumPy
  cumulative pass, or the ``torch`` backend: one CUDA kernel a thread a
  stream), batched across (seeds x policies x arrival rates) via
  :func:`generate_streams`, :func:`simulate_fifo_batch`, and :func:`sweep`.
* ``disciplines`` — masked-argmin engine for SJF, priority and SPJF
  (NumPy busy-period pass, or the ``torch`` backend's sliding-window
  kernel, a warp a stream), with per-stream heapq fallback when a queue
  outgrows the candidate window, plus the preemptive SRPT / SPRPT panel
  kernels (NumPy).
* ``multiserver`` — batched M/G/c next-free-server lanes
  (:func:`free_server_numpy` / :func:`free_server_torch`),
  ``impatience`` — reneging and timeout-retries
  (:func:`impatience_numpy` / :func:`impatience_torch`), and
  ``batch_service`` — the occupancy-dependent stepped DES.

Every entry point defaults to ``backend="numpy"``; ``backend="torch"``
(the JAX package's ``backend="jax"``) runs the CUDA kernels of
``kernels/des_scan.py`` on ``device`` (default: the card; it raises
without one), or their plain versions when ``device="cpu"``.
"""
from .batch_service import BatchServiceSim, simulate_batch_service
from .batched import (BatchStats, SweepResult, lindley_numpy, lindley_torch,
                      simulate_fifo, simulate_fifo_batch, sweep)
from .disciplines import (ALL_DISCIPLINES, DEFAULT_WINDOW, DISCIPLINES,
                          PREDICTED_DISCIPLINES, PREEMPTIVE_DISCIPLINES,
                          discipline_keys, simulate_batch,
                          simulate_discipline, sprpt_numpy,
                          sprpt_start_finish, srpt_numpy,
                          srpt_start_finish, sweep_disciplines,
                          windowed_numpy, windowed_start_finish,
                          windowed_torch)
from .impatience import (ImpatienceResult, RetryPolicy,
                         impatience_event_loop, impatience_numpy,
                         impatience_torch, summarize_impatience)
from .mg1 import (SimResult, event_loop, event_loop_mgc, mgc_prediction,
                  pk_prediction, simulate, sprpt_event_loop,
                  srpt_event_loop)
from .multiserver import (free_server_numpy, free_server_torch, simulate_mgc,
                          simulate_mgc_batch, sweep_mgc)
from .stats import ci95
from .workload import (DriftTrace, Query, Segment, Stream, StreamBatch,
                       empirical_mixture, generate_drift_trace,
                       generate_stream, generate_streams,
                       trace_from_stream_batch)

__all__ = ["SimResult", "simulate", "pk_prediction", "event_loop", "Stream",
           "Query", "generate_stream", "empirical_mixture", "StreamBatch",
           "generate_streams", "BatchStats", "SweepResult", "lindley_numpy",
           "lindley_torch", "simulate_fifo", "simulate_fifo_batch", "sweep",
           "DISCIPLINES", "PREEMPTIVE_DISCIPLINES", "PREDICTED_DISCIPLINES",
           "ALL_DISCIPLINES", "DEFAULT_WINDOW", "discipline_keys",
           "simulate_discipline", "simulate_batch", "sweep_disciplines",
           "windowed_numpy", "windowed_torch", "windowed_start_finish",
           "srpt_numpy", "srpt_start_finish", "srpt_event_loop",
           "sprpt_numpy", "sprpt_start_finish", "sprpt_event_loop",
           "event_loop_mgc", "mgc_prediction", "free_server_numpy",
           "free_server_torch", "simulate_mgc", "simulate_mgc_batch",
           "sweep_mgc", "ci95", "Segment", "DriftTrace",
           "generate_drift_trace", "trace_from_stream_batch",
           "BatchServiceSim", "simulate_batch_service",
           "RetryPolicy", "ImpatienceResult", "impatience_event_loop",
           "impatience_numpy", "impatience_torch", "summarize_impatience"]
