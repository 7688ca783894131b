"""Public white balance module (counterpart of tpu_darktable/white_balance.py)."""

from .ops.white_balance import apply_white_balance, estimate_white_balance

__all__ = ['apply_white_balance', 'estimate_white_balance']
