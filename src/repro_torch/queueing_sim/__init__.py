"""Workload streams and the analytical M/G/1 prediction (serving slice)."""
from .disciplines import DISCIPLINES, discipline_keys
from .mg1 import pk_prediction
from .workload import Query, Stream, generate_stream

__all__ = ["Query", "Stream", "generate_stream", "pk_prediction",
           "discipline_keys", "DISCIPLINES"]
