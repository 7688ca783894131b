"""Frozen plain copies of the measured package's stages (see ../README in
isp_bench/reference/__init__.py)."""
