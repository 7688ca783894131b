"""Utilities (counterpart of tpu_darktable/utils/): stage timing and traces."""

from .timing import StageTimer, benchmark_op, trace_to

__all__ = ['StageTimer', 'benchmark_op', 'trace_to']
