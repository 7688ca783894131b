"""Stage file of the reference for `enable_laplacian`: the local-Laplacian
local contrast, run after bilateral as the port's batched program runs it
(`build_pipeline_fn`'s `_laplacian_one`).  The LAB split follows
`lab_and_lum`: where denoise or bilateral ran before, their output ends in
a clip to [0, 1], so the plain LAB serves both sides; otherwise the clipped
L.  The pyramids keep the port's float16 storage and `auto_max_supp`'s pad
(the full pad 1 << (levels - 1) for any non-neutral curve)."""

from __future__ import annotations

import torch

from ..frozen.ops import color as _color
from ..frozen.ops import laplacian as _laplacian

# the port's defaults of the settings this stage reads (ImageProcessingSettings)
DEFAULTS = {'lap_sigma': 0.2, 'lap_shadows': 1.0, 'lap_highlights': 1.0, 'lap_clarity': 0.0}


def local_contrast(isp, rgb: torch.Tensor) -> torch.Tensor:
    s = dict(DEFAULTS, **isp.s)
    params = _laplacian.LaplacianParams(sigma=s['lap_sigma'], shadows=s['lap_shadows'],
                                        highlights=s['lap_highlights'], clarity=s['lap_clarity'])
    if s['enable_denoise'] or s['enable_bilateral']:
        lab = _color.rgb_to_lab(rgb)
        lum = lab[..., 0]
    else:
        lab, lum = _color.rgb_to_lab_with_clipped_l(rgb)
    out = _laplacian.local_laplacian(lum, params, storage_dtype=torch.float16, max_supp='auto')
    return _color.lab_modify_luminance(lab, out)
