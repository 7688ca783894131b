"""Named processing presets (counterpart of tpu_darktable/pipeline/presets.py):
the reference's three value sets as a delta table over a shared base
(denoise + bilateral + postprocess + vibrance 0.5), plus 'fast', the
adaptive_aces chain at denoise_overlap=2.
"""

from __future__ import annotations

from .config import ImageProcessingSettings, ToneMapper

_COMMON = dict(
    enable_denoise=True,
    enable_bilateral=True,
    postprocess=True,
    vibrance=0.5,
)

_PER_PRESET = {
    'aces': dict(
        tone_gamma=2.2,
        tone_intensity=1.0,
        tone_mapping=ToneMapper.aces,
    ),
    'adaptive_aces': dict(
        tone_gamma=1.5,
        tone_intensity=2.0,
        light_adapt=0.8,
        tone_mapping=ToneMapper.adaptive_aces,
    ),
    'reinhard': dict(
        tone_gamma=1.0,
        tone_intensity=2.5,
        light_adapt=0.8,
        tone_mapping=ToneMapper.reinhard,
    ),
    # Speed preset, opt-in: the quality presets keep the reference's
    # pinned overlap of 4.
    'fast': dict(
        tone_gamma=1.5,
        tone_intensity=2.0,
        light_adapt=0.8,
        tone_mapping=ToneMapper.adaptive_aces,
        denoise_overlap=2,
    ),
}

presets: dict[str, ImageProcessingSettings] = {
    name: ImageProcessingSettings(**_COMMON, **delta) for name, delta in _PER_PRESET.items()
}

aces = presets['aces']
adaptive_aces = presets['adaptive_aces']
reinhard = presets['reinhard']


def get_preset(name: str) -> ImageProcessingSettings:
    try:
        return presets[name]
    except KeyError:
        raise ValueError(f'Unknown preset: {name}. Available: {list(presets)}') from None


__all__ = ['aces', 'adaptive_aces', 'get_preset', 'presets', 'reinhard']
