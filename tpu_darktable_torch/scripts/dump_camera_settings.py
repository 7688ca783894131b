"""Print the shipped camera settings as JSON (counterpart of
tpu_darktable/scripts/dump_camera_settings.py).

    python -m tpu_darktable_torch.scripts.dump_camera_settings [--camera NAME]
"""

from __future__ import annotations

import argparse
import json

from ..pipeline.camera_settings import load_camera_settings_from_dir


def main(argv=None):
    parser = argparse.ArgumentParser(description='Dump camera settings')
    parser.add_argument('--camera', type=str, default=None, help='Only this camera')
    args = parser.parse_args(argv)

    for name, cam in load_camera_settings_from_dir().items():
        if args.camera and name != args.camera:
            continue
        print(f'=== {name} ===')
        print(json.dumps(cam.to_dict(), indent=2))
        print()


if __name__ == '__main__':
    main()
