"""Card ms a frame of the local Laplacian (LAB in, the seven pyramids, the coarse-to-fine assembly,
LAB out): `bilateral` to `laplacian`."""

from isp_bench.tracer import isp_stage

read = isp_stage(('bilateral',), 'laplacian')
