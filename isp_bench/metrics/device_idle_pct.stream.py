"""The card's idle share over the traced slice (percent)."""

from isp_bench.readers import device_idle_pct as read  # noqa: F401
