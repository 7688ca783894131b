"""Card ms a frame of the demosaic (RCD's kernel, edge strips and cats): `decode` to `demosaic`."""

from isp_bench.tracer import isp_stage

read = isp_stage(('decode',), 'demosaic')
