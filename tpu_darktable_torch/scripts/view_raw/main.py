"""view-raw entry point (counterpart of
tpu_darktable/scripts/view_raw/main.py).  Runs the pipeline on `--device`
(default cuda; 'cpu' runs the plain versions); the window needs
matplotlib."""

from __future__ import annotations

import argparse
from pathlib import Path

from ...pipeline.camera_settings import load_camera_settings_from_dir, settings_for_file
from ..util import add_device_argument
from .pipeline_ui import PipelineController
from .ui import ProcessRawUI


def find_raw_files(directory: Path) -> list[Path]:
    files = sorted(
        p for p in Path(directory).rglob('*')
        if p.is_file() and p.suffix.lower() in {'.raw', '.bin', ''}
    )
    if not files:
        raise FileNotFoundError(f'No raw files found under {directory}')
    return files


def main():
    parser = argparse.ArgumentParser(description='Interactive raw viewer/tuner')
    parser.add_argument('path', type=Path, help='Raw file or directory of raw files')
    parser.add_argument('--camera', type=str, default=None,
                        help='Camera settings name (default: auto-detect)')
    add_device_argument(parser)
    args = parser.parse_args()

    path = Path(args.path)
    raw_files = [path] if path.is_file() else find_raw_files(path)

    if args.camera:
        camera_settings = load_camera_settings_from_dir()[args.camera]
    else:
        camera_settings = settings_for_file(raw_files[0])
    print(f'camera: {camera_settings.name} {camera_settings.image_size}')

    controller = PipelineController(camera_settings, raw_files, device=args.device)
    ui = ProcessRawUI(controller)
    ui.run()


if __name__ == '__main__':
    main()
