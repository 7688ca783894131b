"""Card ms per frame of the compiled program (process_batch), summed over the window."""

from isp_bench.readers import isp_card_ms as read  # noqa: F401
