"""Card ms a frame of postprocess (green equalisation, colour smoothing): `demosaic` to
`postprocess`."""

from isp_bench.tracer import isp_stage

read = isp_stage(('demosaic',), 'postprocess')
