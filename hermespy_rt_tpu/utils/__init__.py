"""Utilities: profiling, logging, validation."""
from .cache import enable_compile_cache
from .profiling import TraceStats, time_trace, profile_trace, log_metrics
from .validation import (validate_scene, validate_inputs, check_finite,
                         SceneValidationError)

__all__ = ["enable_compile_cache", "TraceStats", "time_trace", "profile_trace", "log_metrics",
           "validate_scene", "validate_inputs", "check_finite",
           "SceneValidationError"]
