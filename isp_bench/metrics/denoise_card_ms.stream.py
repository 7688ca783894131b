"""Card ms a frame of denoise (LAB in, log, the Wiener stage, exp, LAB out): `normalize` to
`denoise`."""

from isp_bench.tracer import isp_stage

read = isp_stage(('normalize',), 'denoise')
