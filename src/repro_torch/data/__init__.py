"""Data pipeline: the synthetic task stream, the byte tokenizer, and the
service-length predictors the predicted disciplines (SPJF, SPRPT) consume.

NumPy copies of ``repro.data.predictor``, ``repro.data.synthetic`` and
``repro.data.tokenizer``: the same seeds give the same draws in both
packages.
"""
from .predictor import (LengthPredictor, calibrate_from_synthetic,
                        fit_quantile, fit_two_point, lognormal_factors)
from .synthetic import DataConfig, SyntheticTokens
from .tokenizer import BOS_ID, EOS_ID, PAD_ID, ByteTokenizer

__all__ = ["DataConfig", "SyntheticTokens", "ByteTokenizer",
           "PAD_ID", "BOS_ID", "EOS_ID",
           "LengthPredictor", "fit_two_point", "fit_quantile",
           "calibrate_from_synthetic", "lognormal_factors"]
