"""Card ms a frame of bilateral (LAB in, the bilateral grid, LAB out): `denoise` to `bilateral`."""

from isp_bench.tracer import isp_stage

read = isp_stage(('denoise',), 'bilateral')
