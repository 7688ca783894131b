"""Host ms a frame in process_batch before the program's call (the `isp.input` span)."""

from isp_bench.tracer import isp_input_ms as read  # noqa: F401
