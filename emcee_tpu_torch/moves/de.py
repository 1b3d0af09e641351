"""Differential-evolution move (Ter Braak 2006 / Nelson et al. 2013).

The counterpart of ``emcee_tpu/moves/de.py:26-85``: ``q = s + gamma *
(c[j] - c[i])`` with ``i != j`` drawn from the complement and ``gamma =
gamma0 * (1 + sigma * N(0, 1))``, ``gamma0 = 2.38 / sqrt(2 ndim)`` by
default; the Hastings factor is zero (symmetric proposal).  Both pair
modes run through K5a (``ops/de_kernel.py``):

* ``pair_mode="random"``: a uniform ordered pair ``i != j`` per walker
  (``j`` drawn from ``nc - 1`` and moved past ``i``);
* ``pair_mode="roll"``: ``c[(i + s2) % nc] - c[(i + s1) % nc]`` under two
  distinct random shifts per split, independent of the chain state, so
  detailed balance holds.

K5a's rung axis lets :meth:`~.red_blue.RedBlueMove.propose_rungs` propose
every rung of a tempered ladder in one launch a split.
"""

from __future__ import annotations

from ..ops import de_kernel
from .red_blue import RedBlueMove

__all__ = ["DEMove"]


class DEMove(RedBlueMove):
    """Differential evolution proposal.

    Args:
        sigma: stddev of the Gaussian jitter on gamma (default 1e-5).
        gamma0: mean stretch factor; default ``2.38 / sqrt(2 ndim)``.
        pair_mode: ``"random"`` (default, reference-faithful) or
            ``"roll"``.
    """

    tunable = True
    rung_batched = True

    def __init__(self, sigma=1.0e-5, gamma0=None, pair_mode="random",
                 **kwargs):
        self.sigma = float(sigma)
        self.gamma0 = gamma0
        if pair_mode not in ("random", "roll"):
            raise ValueError(f"unknown pair_mode: {pair_mode!r}")
        self.pair_mode = pair_mode
        super().__init__(**kwargs)

    def get_proposal(self, rng, coords, split, model, extra=None,
                     scale=None):
        """K5a for group ``split``.  ``extra`` injects the draws as a dict
        of :func:`~..ops.de_kernel.de_propose` keywords: ``z`` and
        ``u_shift`` (roll) or ``z``, ``idx_a`` and ``idx_b`` (random); on
        the rung axis (``coords`` ``(T, nwalkers, ndim)``, ``rng``'s seed
        a :class:`~..ops.philox.RungKeys`) one row of each per rung."""
        seed, offset = rng
        return de_kernel.de_propose(
            coords, split, self.nsplits,
            gamma0=de_kernel.de_gamma0(
                self.gamma0, model.global_ndim(coords.shape[-1])),
            sigma=self.sigma, scale=scale, pair_mode=self.pair_mode,
            seed=seed, offset=offset, **(extra or {}),
        )
