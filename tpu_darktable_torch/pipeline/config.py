"""Processing settings as a frozen dataclass (counterpart of
tpu_darktable/pipeline/config.py:122-207).

The schema (field names, defaults, ranges, enum values) is the JAX
package's, field for field.  It is a dataclass and not pydantic because the
port must run where pydantic is not installed; ranges are checked in
`__post_init__` and JSON goes through the stdlib.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Literal


class ToneMapper(Enum):
    linear = 0
    reinhard = 1
    aces = 2
    adaptive_aces = 3
    filmic = 4


class Debayer(Enum):
    bilinear = 0
    ppg = 1
    rcd = 2


def _ranged(default, lo, hi):
    return field(default=default, metadata={'range': (lo, hi)})


@dataclass(frozen=True)
class ImageProcessingSettings:
    """The processing config; `range` metadata marks the checked fields."""

    type: Literal['image_processing_settings'] = 'image_processing_settings'

    tone_gamma: float = _ranged(0.75, 0.1, 5.0)
    tone_intensity: float = _ranged(2.0, -1.0, 5.0)
    light_adapt: float = _ranged(1.0, 0.0, 1.0)
    vibrance: float = _ranged(0.0, -1.0, 1.0)
    moving_average: float = _ranged(0.02, 0.0, 1.0)

    debayer: Debayer = Debayer.rcd
    ppg_median_threshold: float = 0.0

    postprocess: bool = False
    green_eq_threshold: float = 0.04
    color_smoothing_passes: int = 3

    enable_bilateral: bool = False
    enable_laplacian: bool = False
    lap_sigma: float = 0.2
    lap_shadows: float = 1.0
    lap_highlights: float = 1.0
    lap_clarity: float = 0.0
    bilateral: float = _ranged(0.4, 0.0, 1.0)

    bil_sigma_spatial: float = 2.0
    bil_sigma_luminance: float = 0.2

    enable_denoise: bool = True
    denoise: float = _ranged(0.075, 0.0, 1.0)
    denoise_overlap: int = _ranged(4, 2, 8)
    # Kept for the JAX package's schema (its FULL stores the Wiener
    # intermediates in float16).  No effect here: the pipeline's Wiener stage
    # is the tile core, which keeps nothing between its transforms to store.
    denoise_f16: bool = True

    tone_mapping: ToneMapper = ToneMapper.reinhard

    resize_width: int = _ranged(0, 0, 4096)

    def __post_init__(self):
        if self.type != 'image_processing_settings':
            raise ValueError(f'type must be image_processing_settings, got {self.type!r}')
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if f.name in ('debayer', 'tone_mapping'):
                enum = Debayer if f.name == 'debayer' else ToneMapper
                if isinstance(value, str):
                    object.__setattr__(self, f.name, enum[value])
                elif not isinstance(value, enum):
                    raise ValueError(f'{f.name}: {value!r} is not a {enum.__name__}')
                continue
            if f.type in ('float', 'int', 'bool'):
                cast = {'float': float, 'int': int, 'bool': bool}[f.type]
                value = cast(value)
                object.__setattr__(self, f.name, value)
            if 'range' in f.metadata:
                lo, hi = f.metadata['range']
                if value < lo or value > hi:
                    raise ValueError(f'{f.name}: {value} not in [{lo}, {hi}]')

    def to_dict(self) -> dict:
        """Plain dict with enum names, the JSON form."""
        d = dataclasses.asdict(self)
        d['debayer'] = self.debayer.name
        d['tone_mapping'] = self.tone_mapping.name
        return d

    @classmethod
    def from_dict(cls, d: dict) -> 'ImageProcessingSettings':
        """Build from a plain dict; unknown keys raise, missing keys default."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f'unknown settings fields: {sorted(unknown)}')
        return cls(**d)

    def save_json(self, path: Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def load_json(cls, path: Path) -> 'ImageProcessingSettings':
        return cls.from_dict(json.loads(Path(path).read_text()))


__all__ = ['Debayer', 'ImageProcessingSettings', 'ToneMapper']
