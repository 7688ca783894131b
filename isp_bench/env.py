"""The environment every command of the benchmark sets before it imports
torch: the port's nvcc builds and any kernel cache at fixed paths inside
the checkout (build/isp_bench/), so only a checkout's first run builds,
and no library that would load JAX behind the port's back."""

import os
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def setup() -> Path:
    cache = CHECKOUT / 'build' / 'isp_bench'
    os.environ['TD_TORCH_BUILD_DIR'] = str(cache / 'libs')
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
    os.environ['USE_FLAX'] = '0'
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))
    return CHECKOUT
