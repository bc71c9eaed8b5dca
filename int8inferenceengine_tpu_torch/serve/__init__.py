"""Serving: continuous-batching engines (counterpart of
``int8inferenceengine_tpu.serve``)."""

from .engine import EngineStats, InferenceEngine
from .generation import GenerationEngine, GenerationStats

__all__ = ["InferenceEngine", "EngineStats", "GenerationEngine",
           "GenerationStats"]
