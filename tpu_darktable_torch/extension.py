"""The binding-level surface (counterpart of tpu_darktable/extension.py).

The reference reaches its C++/CUDA classes and functions through one
binding module (`extension.RCD`, `extension.decode12_float`,
`extension.TonemapParams`, ...).  Here every op is a Python callable, so
the module resolves each name lazily against `tpu_darktable_torch` itself,
with the binding's own spellings as aliases.
"""

from __future__ import annotations

# Binding-level spellings that differ from the Python-level API.
_ALIASES = {
    'TonemapParams': 'TonemapParameters',
    'JpegInputFormat': 'InputFormat',
    'JpegSubsampling': 'Subsampling',
}


def __getattr__(name: str):
    import tpu_darktable_torch

    try:
        return getattr(tpu_darktable_torch, _ALIASES.get(name, name))
    except AttributeError:
        pass
    # names the binding exports but the Python API keeps in a submodule
    # (adaptive_aces_tonemap, ...)
    for sub in (tpu_darktable_torch.tonemap, tpu_darktable_torch.color_conversion,
                tpu_darktable_torch.denoise, tpu_darktable_torch.debayer):
        if hasattr(sub, name):
            return getattr(sub, name)
    raise AttributeError(f"module 'tpu_darktable_torch.extension' has no attribute {name!r}")


def __dir__():
    import tpu_darktable_torch

    return sorted(set(dir(tpu_darktable_torch)))
