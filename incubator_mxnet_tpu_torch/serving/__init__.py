"""Serving of the PyTorch port: `InferenceEngine` (one-shot, bucketed
dynamic batching over a captured program per replica and bucket),
`GenerationEngine` (KV-cached decode with continuous batching over
captured programs) and `ModelRegistry` (many engines behind memory
admission control, versions and circuit breakers)."""
from .engine import (InferenceEngine, QueueFull, DeadlineExceeded,
                     EngineClosed, Shed, serve_counters)
from .generation import (GenerationEngine, GenerationStream,
                         project_generation_footprint)
from .registry import (ModelRegistry, AdmissionDenied, CircuitOpen,
                       UnknownModel, RegistrationTimeout,
                       project_footprint, live_registries)

__all__ = ["InferenceEngine", "QueueFull", "DeadlineExceeded",
           "EngineClosed", "Shed", "serve_counters",
           "GenerationEngine", "GenerationStream",
           "project_generation_footprint",
           "ModelRegistry", "AdmissionDenied", "CircuitOpen",
           "UnknownModel", "RegistrationTimeout", "project_footprint",
           "live_registries"]
