"""Evaluation of the port: metrics, the evaluator and the meter
(counterpart of rap_tpu/eval)."""

from .evaluator import EvalConfig, Evaluator
from .meter import MetricsMeter

__all__ = ["EvalConfig", "Evaluator", "MetricsMeter"]
