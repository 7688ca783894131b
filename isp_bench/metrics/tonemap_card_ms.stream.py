"""Card ms a frame of the sampling, the metrics EMA and the tonemap: `bilateral` (or `laplacian`)
to `tonemap`."""

from isp_bench.tracer import isp_stage

read = isp_stage(('bilateral', 'laplacian'), 'tonemap')
