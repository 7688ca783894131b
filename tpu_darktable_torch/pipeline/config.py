"""Processing settings as a frozen dataclass, and the validators that
describe its fields (counterpart of tpu_darktable/pipeline/config.py).

The schema (field names, defaults, ranges, enum values) is the JAX
package's, field for field.  It is a dataclass and not pydantic because the
port must run where pydantic is not installed.  Each checked field carries
its validator in the dataclass field's metadata, where `get_validator`
finds it for a UI and `__post_init__` coerces and checks through it, so the
ranges live in one place; JSON goes through the stdlib.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Literal


class Validator:
    """UI-introspectable field constraint, carried in a dataclass field's
    metadata.  Subclasses implement ``coerce(value) -> value`` (raising
    ValueError on a constraint violation) and may set ``serialize`` for a
    custom JSON form."""

    description: str = ''

    def coerce(self, value):
        return value

    serialize = None  # optional: fn(value) -> json-compatible value


class _NumberInRange(Validator):
    """Shared numeric range check; `_cast` picks the target type."""

    _cast: type

    def __init__(self, range, description: str, step=None):
        self.range = range
        self.description = description
        self.step = step

    def coerce(self, value):
        value = self._cast(value)
        lo, hi = self.range
        if value < lo or value > hi:
            raise ValueError(f'{value} not in [{lo}, {hi}]')
        return value


class Float(_NumberInRange):
    _cast = float


class Int(_NumberInRange):
    _cast = int


class Bool(Validator):
    def __init__(self, description: str):
        self.description = description

    coerce = staticmethod(bool)


class EnumValidator[TEnum: Enum](Validator):
    """Name string <-> enum member, plus dict-of-enum values (the per-camera
    transform maps of beetroot.json)."""

    def __init__(self, enum_type: type[TEnum], description: str):
        self.enum_type = enum_type
        self.description = description

    def _member(self, value):
        if isinstance(value, self.enum_type):
            return value
        if isinstance(value, str):
            return self.enum_type[value]
        raise ValueError(f'{value} is not a {self.enum_type.__name__}')

    def coerce(self, value):
        if isinstance(value, dict):
            return {key: self._member(item) for key, item in value.items()}
        return self._member(value)

    @staticmethod
    def serialize(value):
        if isinstance(value, dict):
            return {key: item.name for key, item in value.items()}
        return value.name


def checked(default, validator: Validator):
    """A dataclass field whose values go through `validator`."""
    return field(default=default, metadata={'validator': validator})


def get_validator(model, field_name: str) -> Validator | None:
    """A dataclass field's validator, or None for an unchecked field."""
    for f in dataclasses.fields(model):
        if f.name == field_name:
            return f.metadata.get('validator')
    return None


def coerce_fields(obj) -> None:
    """Run every checked field of a frozen dataclass through its validator
    in place.  A value out of range or of the wrong kind raises ValueError
    naming the field; an unknown enum name raises the enum's KeyError, as
    it does through the JAX package's pydantic models."""
    for f in dataclasses.fields(obj):
        validator = f.metadata.get('validator')
        if validator is None:
            continue
        try:
            value = validator.coerce(getattr(obj, f.name))
        except ValueError as e:
            raise ValueError(f'{f.name}: {e}') from e
        object.__setattr__(obj, f.name, value)


def serialize_fields(obj) -> dict:
    """A dataclass's fields as a dict, each checked field in its
    validator's JSON form."""
    out = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        serialize = getattr(f.metadata.get('validator'), 'serialize', None)
        out[f.name] = value if serialize is None else serialize(value)
    return out


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


def clamp(x, lower, upper):
    return min(max(x, lower), upper)


@dataclass(frozen=True)
class ImageProcessingSettings:
    """The processing config; each checked field carries its validator."""

    type: Literal['image_processing_settings'] = 'image_processing_settings'

    tone_gamma: float = checked(0.75, Float(range=(0.1, 5.0), description='Gamma'))
    tone_intensity: float = checked(2.0, Float(range=(-1.0, 5.0), description='Intensity'))
    light_adapt: float = checked(1.0, Float(range=(0.0, 1.0), description='Light adaptation'))
    vibrance: float = checked(0.0, Float(range=(-1.0, 1.0), description='Vibrance'))
    moving_average: float = checked(
        0.02, Float(range=(0.0, 1.0), description='Tonemap moving average'))

    debayer: Debayer = checked(Debayer.rcd, EnumValidator(Debayer, description='Debayer algorithm'))
    ppg_median_threshold: float = 0.0

    postprocess: bool = checked(False, Bool(description='Postprocess debayer'))
    green_eq_threshold: float = 0.04
    color_smoothing_passes: int = 3

    enable_bilateral: bool = checked(
        False, Bool(description='Enable bilateral constrast enhancement'))
    enable_laplacian: bool = checked(False, Bool(description='Enable local-Laplacian contrast'))
    lap_sigma: float = 0.2
    lap_shadows: float = 1.0
    lap_highlights: float = 1.0
    lap_clarity: float = 0.0
    bilateral: float = checked(
        0.4, Float(range=(0.0, 1.0), description='Bilateral constrast enhancement amount'))

    bil_sigma_spatial: float = 2.0
    bil_sigma_luminance: float = 0.2

    enable_denoise: bool = checked(True, Bool(description='Enable denoise'))
    denoise: float = checked(0.075, Float(range=(0.0, 1.0), description='Denoise amount'))
    denoise_overlap: int = checked(
        4, Int(range=(2, 8), description='Denoise tile overlap factor', step=2))
    # The Wiener stage's route: the separable einsums storing their spectral
    # intermediates in float16 (the JAX package's default), or the float32
    # tile core (kernels/wiener_core.py).
    denoise_f16: bool = checked(
        True, Bool(description='Store Wiener spectra in float16 (faster)'))

    tone_mapping: ToneMapper = checked(
        ToneMapper.reinhard, EnumValidator(ToneMapper, description='Tonemapping algorithm'))

    resize_width: int = checked(0, Int(range=(0, 4096), description='Resize width'))

    def __post_init__(self):
        if self.type != 'image_processing_settings':
            raise ValueError(f'type must be image_processing_settings, got {self.type!r}')
        for f in dataclasses.fields(self):
            if 'validator' not in f.metadata and f.type in ('float', 'int', 'bool'):
                cast = {'float': float, 'int': int, 'bool': bool}[f.type]
                object.__setattr__(self, f.name, cast(getattr(self, f.name)))
        coerce_fields(self)

    def to_dict(self) -> dict:
        """Plain dict with enum names, the JSON form."""
        return serialize_fields(self)

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


__all__ = ['Bool', 'Debayer', 'EnumValidator', 'Float', 'ImageProcessingSettings', 'Int', 'ToneMapper',
           'Validator', 'clamp', 'get_validator']
