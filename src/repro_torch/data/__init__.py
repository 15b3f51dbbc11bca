"""Data pipeline: the synthetic task stream and the service-length
predictors the predicted disciplines (SPJF, SPRPT) consume.

NumPy copies of ``repro.data.predictor`` and ``repro.data.synthetic``:
the same seeds give the same draws in both packages.
"""
from .predictor import (LengthPredictor, calibrate_from_synthetic,
                        fit_quantile, fit_two_point, lognormal_factors)
from .synthetic import DataConfig, SyntheticTokens

__all__ = ["DataConfig", "SyntheticTokens",
           "LengthPredictor", "fit_two_point", "fit_quantile",
           "calibrate_from_synthetic", "lognormal_factors"]
