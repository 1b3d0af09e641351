"""Public autocorrelation module (mirrors ``emcee_tpu.autocorr``).

The implementation lives in :mod:`emcee_tpu_torch.ops.autocorr`.
"""

from .ops.autocorr import (  # noqa: F401
    AutocorrError,
    ess,
    function_1d,
    integrated_time,
    next_pow_two,
    rhat,
)

__all__ = ["function_1d", "integrated_time", "ess", "rhat", "AutocorrError",
           "next_pow_two"]
