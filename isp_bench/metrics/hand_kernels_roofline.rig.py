"""The hand kernels' share of their roofline over the traced slice (percent)."""

from isp_bench.readers import roofline_pct as read  # noqa: F401
