"""Public autocorrelation module (mirrors ``emcee_tpu.autocorr``).

The implementation lives in :mod:`emcee_tpu_torch.ops.autocorr`.
"""

from .ops.autocorr import (  # noqa: F401
    AutocorrError,
    function_1d,
    integrated_time,
    next_pow_two,
)

__all__ = ["function_1d", "integrated_time", "AutocorrError", "next_pow_two"]
