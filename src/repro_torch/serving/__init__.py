"""Serving runtime: allocator-driven FIFO LLM server with budget enforcement,
admission control and fault hooks."""
from ..obs.trace import timecall
from .admission import (SHED_CLASS, AdmissionConfig, AdmissionController,
                        AdmissionDecision)
from .continuous import BlockAllocator, ContinuousBatchingEngine, Slot
from .engine import DecodeEngine
from .metrics import (ServingReport, empty_report, occupancy_summary,
                      percentile_summary, summarize)
from .request import CompletedRequest, Phase, Request
from .scheduler import Scheduler
from .server import LLMServer, ServerConfig

__all__ = ["DecodeEngine", "ContinuousBatchingEngine", "BlockAllocator",
           "Slot", "AdmissionController", "AdmissionConfig",
           "AdmissionDecision", "SHED_CLASS", "LLMServer", "ServerConfig",
           "Scheduler", "Request",
           "CompletedRequest", "Phase", "ServingReport", "summarize",
           "empty_report", "occupancy_summary", "percentile_summary",
           "timecall"]
