"""Profiling of the port: ``trace_step`` records a ``torch.profiler`` trace,
``ProfilerParser`` turns it into a per-op table, and ``span`` marks the
program's own stretches of work in such a trace."""

from spectre_tpu_torch.profile.parser import ProfilerParser
from spectre_tpu_torch.profile.spans import span
from spectre_tpu_torch.profile.tracer import trace_step

__all__ = ["ProfilerParser", "span", "trace_step"]
