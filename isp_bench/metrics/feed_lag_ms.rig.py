"""Median lateness (ms) of the open loop's frames when the streaming executor took them."""

from isp_bench.readers import feed_lag_ms as read  # noqa: F401
