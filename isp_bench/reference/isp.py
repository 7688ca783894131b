"""The reference ISP: one frame at a time, plain PyTorch, in the order the
measured program's batched program runs its stages.

    decode12 -> white balance -> RCD -> postprocess      (front, per frame)
    bounds EMA over the batch's stride-8 samples
    normalize -> Wiener on log LAB-L -> bilateral        (back, per frame)
    metrics EMA over the batch's stride-8 samples
    tonemap -> uint8

The stages are the frozen plain copies in `frozen/`.  A setting the
built-in stages do not cover (BUILT_IN) is covered by a stage file in
`routes/`, found by the setting's name: `routes/<setting>.<value>.py` for
a string value (`tone_mapping.reinhard.py`), `routes/<setting>.py` for any
other (`enable_laplacian.py`).  It defines one or more of STAGES, each
taking the ReferenceISP first; a setting no file covers raises
NotImplementedError when the ReferenceISP is made.  With
`lower_precision` every stage's output is rounded to bfloat16 before the
next stage reads it: that is the control, the step below the float32 that
the configuration states, which the comparison must reject.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from pathlib import Path

import torch

from .frozen.ops import bilateral as _bilateral
from .frozen.ops import color as _color
from .frozen.ops import packed as _packed
from .frozen.ops import postprocess as _postprocess
from .frozen.ops import rcd as _rcd
from .frozen.ops import tonemap as _tonemap
from .frozen.ops import white_balance as _wb
from .frozen.ops import wiener as _wiener
from .frozen.ops.bayer import BayerPattern
from .frozen.transform import ImageTransform, transform
from .frozen.util import lerp, normalize_image

# the defaults of the settings the camera files leave out
DEFAULTS = {
    'tone_gamma': 0.75, 'tone_intensity': 2.0, 'light_adapt': 1.0, 'vibrance': 0.0,
    'moving_average': 0.02, 'debayer': 'rcd', 'postprocess': False,
    'color_smoothing_passes': 3, 'enable_bilateral': False, 'enable_laplacian': False,
    'bilateral': 0.4, 'bil_sigma_spatial': 2.0, 'bil_sigma_luminance': 0.2,
    'enable_denoise': True, 'denoise': 0.075, 'denoise_overlap': 4, 'denoise_f16': True,
    'tone_mapping': 'reinhard', 'resize_width': 0,
}
ROUTES = Path(__file__).resolve().parent / 'routes'
# the values of each setting that the built-in stages cover
BUILT_IN = {'debayer': ('rcd',), 'enable_laplacian': (False,), 'resize_width': (0,),
            'tone_mapping': ('aces', 'adaptive_aces')}
# what a stage file may define: demosaic(isp, bayer) -> rgb in RCD's place;
# local_contrast(isp, rgb) -> rgb after bilateral; tonemap(isp, rgb, metrics)
# -> uint8 in ACES's place
STAGES = ('demosaic', 'local_contrast', 'tonemap')


def _stages_of(path: Path) -> dict:
    """The STAGES that the stage file at `path` defines, loaded as a module
    of this package's routes/ (its relative imports reach frozen/)."""
    name = f"{__package__}.routes.{path.stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    found = {k: getattr(module, k) for k in STAGES if callable(getattr(module, k, None))}
    if not found:
        raise NotImplementedError(f'{path.name} defines none of {STAGES}')
    return found


def routes_for(settings: dict) -> dict:
    """Stage name -> function, from the stage files of every setting the
    built-in stages do not cover; raises NotImplementedError for a setting
    no file covers."""
    stages = {}
    for setting, values in BUILT_IN.items():
        value = settings[setting]
        if value in values:
            continue
        path = ROUTES / (f'{setting}.{value}.py' if isinstance(value, str) else f'{setting}.py')
        if not path.is_file():
            raise NotImplementedError(f'{setting} = {value!r}: the reference has no stage '
                                      f'file {path.relative_to(ROUTES.parent)}')
        stages.update(_stages_of(path))
    return stages


@dataclass(frozen=True)
class Camera:
    """What the reference reads of a camera settings file."""

    width: int
    height: int
    pattern: BayerPattern
    ids: bool
    padding: int
    white_balance: tuple | None
    transform: object            # an ImageTransform or {name: ImageTransform}
    settings: dict

    @staticmethod
    def from_dict(d: dict) -> 'Camera':
        s = dict(DEFAULTS)
        s.update({k: v for k, v in d['image_processing'].items() if k != 'type'})
        tf = d.get('transform', 'none')
        tf = ({k: ImageTransform[v] for k, v in tf.items()} if isinstance(tf, dict)
              else ImageTransform[tf])
        wb = d.get('white_balance')
        return Camera(int(d['image_size'][0]), int(d['image_size'][1]),
                      BayerPattern[d.get('bayer_pattern', 'RGGB')],
                      d.get('packed_format', 'Packed12') == 'Packed12_IDS',
                      int(d.get('padding', 0)), None if wb is None else tuple(wb), tf, s)

    def transform_of(self, name: str):
        if isinstance(self.transform, dict):
            return self.transform.get(name, ImageTransform.none)
        return self.transform


class ReferenceISP:
    def __init__(self, camera: Camera, device, lower_precision: bool = False):
        s = camera.settings
        if s['enable_denoise'] and not s['denoise_f16']:
            raise NotImplementedError('Wiener: the separable float16 route only')
        self.stages = routes_for(s)
        self.camera = camera
        self.s = s
        self.device = torch.device(device)
        self.lower = lower_precision
        wb = camera.white_balance
        self.wb = None if wb is None else torch.tensor(wb, dtype=torch.float32, device=self.device)
        if self.device.type == 'cuda':
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16).to(torch.float32) if self.lower else x

    def front(self, packed: torch.Tensor) -> torch.Tensor:
        """Packed bytes (n,) uint8 of one frame -> (H, W, 3) float32."""
        c = self.camera
        rows = packed.to(self.device)
        if c.padding:
            rows = rows[: -c.padding]
        bayer = _packed.decode12_float(rows.reshape(c.height, (c.width * 3) // 2), ids_format=c.ids)
        if self.wb is not None:
            bayer = _wb.apply_white_balance(bayer, self.wb, c.pattern)
        demosaic = self.stages.get('demosaic')
        if demosaic is None:
            rgb = self._q(_rcd.rcd_demosaic(self._q(bayer), c.pattern, strict_alias=True))
        else:
            rgb = self._q(demosaic(self, self._q(bayer)))
        if self.s['postprocess']:
            rgb = _postprocess.postprocess(
                rgb, c.pattern, color_smoothing_passes=self.s['color_smoothing_passes'],
                green_eq_global_enabled=True)
        return self._q(rgb)

    def back(self, rgb: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
        s = self.s
        rgb = self._q(normalize_image(rgb, bounds))
        if s['enable_denoise']:
            lab, lum = _color.rgb_to_lab_with_clipped_l(rgb)
            log_lum = torch.log(torch.clamp(lum, min=1e-4))
            f16 = torch.float16 if s['denoise_f16'] else None
            den = _wiener.wiener_denoise(
                log_lum[..., None], s['denoise'], tile_size=32,
                overlap_factor=s['denoise_overlap'], use_separable=s['denoise_f16'],
                spectral_dtype=f16, storage_dtype=f16)[..., 0]
            rgb = self._q(_color.lab_modify_luminance(lab, torch.exp(den + 1e-4)))
        if s['enable_bilateral']:
            if s['enable_denoise']:
                lab = _color.rgb_to_lab(rgb)
                lum = lab[..., 0]
            else:
                lab, lum = _color.rgb_to_lab_with_clipped_l(rgb)
            out = _bilateral.bilateral_process(lum, s['bil_sigma_spatial'],
                                               s['bil_sigma_luminance'], s['bilateral'])
            rgb = self._q(_color.lab_modify_luminance(lab, out))
        if 'local_contrast' in self.stages:
            rgb = self._q(self.stages['local_contrast'](self, rgb))
        return rgb

    def tonemap(self, rgb: torch.Tensor, metrics: torch.Tensor) -> torch.Tensor:
        if 'tonemap' in self.stages:
            return self.stages['tonemap'](self, rgb, metrics)
        s = self.s
        params = _tonemap.TonemapParameters(s['tone_gamma'], s['tone_intensity'],
                                            s['light_adapt'], s['vibrance'])
        adaptive = metrics if s['tone_mapping'] == 'adaptive_aces' else None
        return _tonemap.aces_tonemap(rgb, params, adaptive)

    @staticmethod
    def sample(rgb: torch.Tensor) -> torch.Tensor:
        return rgb[::8, ::8]

    @staticmethod
    def batch_bounds(samples: list) -> torch.Tensor:
        return _tonemap.compute_image_bounds(torch.stack(samples), stride=1)

    @staticmethod
    def batch_metrics(samples: list) -> torch.Tensor:
        return _tonemap.compute_image_metrics(torch.stack(samples), stride=1)

    def alpha(self, first: bool) -> torch.Tensor:
        a = 1.0 if first else self.s['moving_average']
        return torch.full((), a, dtype=torch.float32, device=self.device)

    def run_batch(self, frames: list, bounds: torch.Tensor, metrics_in: torch.Tensor,
                  alpha: torch.Tensor):
        """The back half of one batch: `bounds` are the batch's bounds after
        their EMA; returns (uint8 frames, metrics after their EMA)."""
        rgbs = [self.back(self.front(f), bounds) for f in frames]
        metrics = lerp(metrics_in, self.batch_metrics([self.sample(x) for x in rgbs]), alpha)
        return [self.tonemap(x, metrics) for x in rgbs], metrics

    def oriented(self, u8: torch.Tensor, name: str) -> torch.Tensor:
        return transform(u8, self.camera.transform_of(name)).contiguous()


__all__ = ['BUILT_IN', 'Camera', 'ROUTES', 'ReferenceISP', 'STAGES', 'lerp', 'routes_for']
