"""Camera settings registry (counterpart of
tpu_darktable/pipeline/camera_settings.py:24-106): a frozen dataclass with
JSON round trip, and the directory of per-camera JSON files shipped in
tpu_darktable_torch/camera_settings/."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Literal

from ..ops.bayer import BayerPattern, PackedFormat
from .config import ImageProcessingSettings
from .transform import ImageTransform


@dataclass(frozen=True)
class CameraSettings:
    """Per-camera geometry + processing config."""

    name: str
    image_size: tuple[int, int]
    image_processing: ImageProcessingSettings
    padding: int = 0
    bayer_pattern: BayerPattern = BayerPattern.RGGB
    packed_format: PackedFormat = PackedFormat.Packed12
    white_balance: tuple[float, float, float] | None = None
    transform: ImageTransform | dict[str, ImageTransform] = ImageTransform.none
    type: Literal['camera_settings'] = 'camera_settings'

    @property
    def bytes(self) -> int:
        return ((self.image_size[0] * self.image_size[1] * 3) // 2) + self.padding

    def get_image_transform(self, camera_name: str) -> ImageTransform:
        if isinstance(self.transform, dict):
            return self.transform.get(camera_name, ImageTransform.none)
        return self.transform

    @classmethod
    def from_dict(cls, d: dict) -> 'CameraSettings':
        tf = d.get('transform', 'none')
        transform = ({k: ImageTransform[v] for k, v in tf.items()} if isinstance(tf, dict)
                     else ImageTransform[tf])
        wb = d.get('white_balance')
        return cls(
            name=d['name'],
            image_size=tuple(d['image_size']),
            image_processing=ImageProcessingSettings.from_dict(d['image_processing']),
            padding=int(d.get('padding', 0)),
            bayer_pattern=BayerPattern[d.get('bayer_pattern', 'RGGB')],
            packed_format=PackedFormat[d.get('packed_format', 'Packed12')],
            white_balance=None if wb is None else tuple(float(v) for v in wb),
            transform=transform,
        )

    def to_dict(self) -> dict:
        tf = self.transform
        return {
            'type': self.type,
            'name': self.name,
            'image_size': list(self.image_size),
            'padding': self.padding,
            'bayer_pattern': self.bayer_pattern.name,
            'packed_format': self.packed_format.name,
            'white_balance': None if self.white_balance is None else list(self.white_balance),
            'image_processing': self.image_processing.to_dict(),
            'transform': ({k: v.name for k, v in tf.items()} if isinstance(tf, dict) else tf.name),
        }

    def save_json(self, path: Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def load_json(cls, path: Path) -> 'CameraSettings':
        return cls.from_dict(json.loads(Path(path).read_text()))


def get_camera_settings_dir() -> Path:
    return Path(__file__).parent.parent / 'camera_settings'


def load_camera_settings_from_dir(settings_dir: Path | None = None) -> dict[str, CameraSettings]:
    settings_dir = get_camera_settings_dir() if settings_dir is None else Path(settings_dir)
    out = {}
    for json_file in sorted(settings_dir.glob('*.json')):
        cs = CameraSettings.load_json(json_file)
        out[cs.name] = cs
    return out


__all__ = ['CameraSettings', 'get_camera_settings_dir', 'load_camera_settings_from_dir']
