"""Profiling of the port: ``trace_step`` records a ``torch.profiler`` trace,
``ProfilerParser`` turns it into a per-op table."""

from spectre_tpu_torch.profile.parser import ProfilerParser
from spectre_tpu_torch.profile.tracer import trace_step

__all__ = ["ProfilerParser", "trace_step"]
