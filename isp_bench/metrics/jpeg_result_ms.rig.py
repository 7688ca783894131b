"""Host ms a frame in PendingJpeg.result, over the drains of the window's batches."""

from isp_bench.tracer import jpeg_result_ms as read  # noqa: F401
