"""Utilities (counterpart of tpu_darktable/utils/): stage timing, traces and
the port's tracer (`timing`)."""

from . import timing
from .timing import StageTimer, benchmark_op, trace_to

__all__ = ['StageTimer', 'benchmark_op', 'timing', 'trace_to']
