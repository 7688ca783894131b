"""Camera settings registry and raw file IO (counterpart of
tpu_darktable/pipeline/camera_settings.py): a frozen dataclass with JSON
round trip, the directory of per-camera JSON files shipped in
tpu_darktable_torch/camera_settings/ resolved by directory name or file
size, and the raw byte loaders, which put a file's bytes on the card unless
the caller asks for the CPU."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Literal

import numpy as np
import torch

from .._device import resolve_device, to_device
from ..ops.bayer import BayerPattern, PackedFormat
from ..ops.packed import decode12
from .config import EnumValidator, ImageProcessingSettings, checked, coerce_fields, serialize_fields
from .transform import ImageTransform


@dataclass(frozen=True)
class CameraSettings:
    """Per-camera geometry + processing config."""

    name: str
    image_size: tuple[int, int]
    image_processing: ImageProcessingSettings
    padding: int = 0
    bayer_pattern: BayerPattern = checked(BayerPattern.RGGB,
                                          EnumValidator(BayerPattern, 'Bayer pattern'))
    packed_format: PackedFormat = checked(PackedFormat.Packed12,
                                          EnumValidator(PackedFormat, 'Packed format'))
    white_balance: tuple[float, float, float] | None = None
    transform: ImageTransform | dict[str, ImageTransform] = checked(
        ImageTransform.none, EnumValidator(ImageTransform, 'Image transform'))
    type: Literal['camera_settings'] = 'camera_settings'

    def __post_init__(self):
        coerce_fields(self)

    @property
    def bytes(self) -> int:
        return ((self.image_size[0] * self.image_size[1] * 3) // 2) + self.padding

    def get_image_transform(self, camera_name: str) -> ImageTransform:
        if isinstance(self.transform, dict):
            return self.transform.get(camera_name, ImageTransform.none)
        return self.transform

    @classmethod
    def from_dict(cls, d: dict) -> 'CameraSettings':
        wb = d.get('white_balance')
        return cls(
            name=d['name'],
            image_size=tuple(d['image_size']),
            image_processing=ImageProcessingSettings.from_dict(d['image_processing']),
            padding=int(d.get('padding', 0)),
            bayer_pattern=d.get('bayer_pattern', 'RGGB'),
            packed_format=d.get('packed_format', 'Packed12'),
            white_balance=None if wb is None else tuple(float(v) for v in wb),
            transform=d.get('transform', 'none'),
        )

    def to_dict(self) -> dict:
        d = serialize_fields(self)
        d.update(image_size=list(self.image_size),
                 white_balance=None if self.white_balance is None else list(self.white_balance),
                 image_processing=self.image_processing.to_dict())
        return d

    def save_json(self, path: Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def load_json(cls, path: Path) -> 'CameraSettings':
        return cls.from_dict(json.loads(Path(path).read_text()))


def load_raw_bytes(filepath: Path, device=None) -> torch.Tensor:
    """A raw file's bytes as a uint8 tensor on `device` (the card unless
    the caller asks for the CPU)."""
    data = np.fromfile(Path(filepath), dtype=np.uint8)
    return to_device(torch.from_numpy(data), resolve_device(device))


def load_raw_bytes_stripped(filepath: Path, camera_settings: CameraSettings,
                            device=None) -> torch.Tensor:
    """load_raw_bytes without the camera's trailing padding."""
    raw = load_raw_bytes(filepath, device)
    if camera_settings.padding > 0:
        raw = raw[: -camera_settings.padding]
    return raw


def load_raw_bayer(filepath: Path, camera_settings: CameraSettings | None = None,
                   device=None) -> torch.Tensor:
    """Load and unpack a raw file to an (H, W) float32 Bayer plane; the
    camera is resolved from the file when not given."""
    if camera_settings is None:
        camera_settings = settings_for_file(Path(filepath))
    width, _height = camera_settings.image_size
    raw = load_raw_bytes_stripped(filepath, camera_settings, device)
    decoded = decode12(raw, output_dtype=torch.float32, format_type=camera_settings.packed_format)
    return decoded.reshape(-1, width)


def get_camera_settings_dir() -> Path:
    return Path(__file__).parent.parent / 'camera_settings'


def load_camera_settings_from_dir(settings_dir: Path | None = None) -> dict[str, CameraSettings]:
    settings_dir = get_camera_settings_dir() if settings_dir is None else Path(settings_dir)
    out = {}
    for json_file in sorted(settings_dir.glob('*.json')):
        cs = CameraSettings.load_json(json_file)
        out[cs.name] = cs
    return out


def settings_for_file(file_path: Path) -> CameraSettings:
    """Resolve camera settings by the file's directory name, then by its
    size in bytes."""
    file_path = Path(file_path)
    all_settings = load_camera_settings_from_dir()

    camera_name = file_path.parent.stem
    if camera_name in all_settings:
        return all_settings[camera_name]

    file_size = file_path.stat().st_size
    for settings in all_settings.values():
        if settings.bytes == file_size:
            return settings

    raise ValueError(
        f'Could not find camera settings for "{file_path}". '
        f'Directory name "{camera_name}" not recognized and file size {file_size} bytes '
        f'does not match any known camera. Available cameras: {list(all_settings.keys())}'
    )


def validate_camera_names(settings: CameraSettings, camera_names: list[str]) -> None:
    """Check a per-camera transform map's keys against the rig's names."""
    if isinstance(settings.transform, dict):
        expected = set(settings.transform.keys())
        actual = set(camera_names)
        if expected != actual:
            raise ValueError(
                f'Camera names mismatch: settings expects {sorted(expected)}, got {sorted(actual)}'
            )


__all__ = ['CameraSettings', 'get_camera_settings_dir', 'load_camera_settings_from_dir',
           'load_raw_bayer', 'load_raw_bytes', 'load_raw_bytes_stripped', 'settings_for_file',
           'validate_camera_names']
