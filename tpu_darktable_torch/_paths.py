"""Where the port writes the libraries it builds at first use.

In a checkout (the package beside the repository's pyproject.toml) that is
`build/<kind>/` at its root, which .gitignore lists.  An installed package
does not sit in a checkout, so it builds into the user's cache directory
(`$XDG_CACHE_HOME` or `~/.cache`, then `tpu_darktable_torch/<kind>`).
TD_TORCH_BUILD_DIR, where set, is the directory itself for every kind.
"""

from __future__ import annotations

import os
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent


def build_root(kind: str) -> Path:
    """The build directory for `kind` ('kernels' or 'native'), created."""
    env = os.environ.get('TD_TORCH_BUILD_DIR')
    if env:
        root = Path(env)
    elif (PACKAGE.parent / 'pyproject.toml').is_file():
        root = PACKAGE.parent / 'build' / kind
    else:
        cache = os.environ.get('XDG_CACHE_HOME') or Path.home() / '.cache'
        root = Path(cache) / 'tpu_darktable_torch' / kind
    root.mkdir(parents=True, exist_ok=True)
    return root


__all__ = ['build_root']
