"""Serving of the PyTorch port: `InferenceEngine` (one-shot, bucketed
dynamic batching) and `GenerationEngine` (KV-cached decode with
continuous batching over captured programs)."""
from .engine import (InferenceEngine, QueueFull, DeadlineExceeded,
                     EngineClosed, Shed)
from .generation import (GenerationEngine, GenerationStream,
                         project_generation_footprint)

__all__ = ["InferenceEngine", "QueueFull", "DeadlineExceeded",
           "EngineClosed", "Shed",
           "GenerationEngine", "GenerationStream",
           "project_generation_footprint"]
