"""Device resolution for the port's public entry points.

Entry points run on the card unless the caller asks for the CPU.  Asking
for the card where there is none raises: nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> 'cuda'; a CUDA device that is not present raises."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {dev} was requested but torch.cuda.is_available() is False; '
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


__all__ = ['resolve_device']
