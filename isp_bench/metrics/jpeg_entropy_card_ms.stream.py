"""Card ms a frame of the device entropy scan of the window's JPEG encodes: `jpeg.dct` to
`jpeg.scan`."""

from isp_bench.tracer import jpeg_stage

read = jpeg_stage(('jpeg.dct',), 'jpeg.scan')
