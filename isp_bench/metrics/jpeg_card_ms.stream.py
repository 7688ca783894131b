"""Card ms per frame of the work launched outside process_batch: the JPEG stages."""

from isp_bench.readers import jpeg_card_ms as read  # noqa: F401
