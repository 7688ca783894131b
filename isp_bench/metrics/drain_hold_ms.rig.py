"""Median ms of a window batch between the end of its flush and the start of its drain."""

from isp_bench.tracer import drain_hold_ms as read  # noqa: F401
