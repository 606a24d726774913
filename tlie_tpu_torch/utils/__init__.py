"""Host-side utilities of the port: the run logger and the profiling hooks."""

from .logging import RunLogger
from .profiling import StepTimer, annotate, profile_trace

__all__ = ["RunLogger", "StepTimer", "annotate", "profile_trace"]
