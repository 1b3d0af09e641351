"""Parallel tempering (``emcee_tpu/parallel/``).

The JAX package's mesh helpers (``walker_mesh``, ``multihost``) are not
ported yet (ROADMAP P13).
"""

from .tempering import PTSampler, PTState, default_beta_ladder

__all__ = ["PTSampler", "PTState", "default_beta_ladder"]
