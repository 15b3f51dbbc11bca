"""Serving runtime: allocator-driven FIFO LLM server with budget enforcement,
admission control and fault hooks.

The closed control loop:

* ``estimators``: online (lambda, pi, E[S], E[S^2], latency-curve)
  estimation from the observed request stream (EWMA or sliding window).
* ``replay``: the trace-replay digital twin: blocks of a recorded trace
  are served (virtual latency model or real decodes through
  ``DecodeEngine``), the observations feed the estimators, and token
  budgets are re-solved on a cadence or on the drift alarm through
  ``sweeps.solve_grid``, with no oracle operating point.
"""
from ..obs.trace import timecall
from .admission import (SHED_CLASS, AdmissionConfig, AdmissionController,
                        AdmissionDecision)
from .continuous import BlockAllocator, ContinuousBatchingEngine, Slot
from .engine import DecodeEngine
from .estimators import (EstimatorState, LatencyCalibrator, MixtureEstimator,
                         OnlineEstimators, RateEstimator,
                         ServiceMomentEstimator)
from .metrics import (ServingReport, empty_report, occupancy_summary,
                      percentile_summary, summarize)
from .replay import (BlockRecord, Controller, ReplayConfig, ReplayHarness,
                     ReplayResult)
from .request import CompletedRequest, Phase, Request
from .scheduler import Scheduler
from .server import LLMServer, ServerConfig

__all__ = ["DecodeEngine", "ContinuousBatchingEngine", "BlockAllocator",
           "Slot", "AdmissionController", "AdmissionConfig",
           "AdmissionDecision", "SHED_CLASS", "LLMServer", "ServerConfig",
           "Scheduler", "Request",
           "CompletedRequest", "Phase", "ServingReport", "summarize",
           "empty_report", "occupancy_summary", "percentile_summary",
           "timecall",
           "RateEstimator", "MixtureEstimator", "ServiceMomentEstimator",
           "LatencyCalibrator", "OnlineEstimators", "EstimatorState",
           "ReplayConfig", "ReplayHarness", "ReplayResult", "Controller",
           "BlockRecord"]
