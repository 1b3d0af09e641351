"""Gaussianized difference ("side") move.

The counterpart of ``emcee_tpu/moves/side.py:33-85``: the walker steps
along the difference of two complement members with a Gaussian
amplitude, ``q = s + (sigma / sqrt(2)) * z * (c_j - c_i)``, ``z ~ N(0,
1)``, ``sigma = 2.38 / sqrt(ndim)`` by default; the Hastings factor is
zero (``z`` is sign-symmetric and the pair exchangeable).  The proposal
is K5a's side mode (``ops/de_kernel.py``, ``csrc/de_propose.cu``); each
split's accept/select is K2.

The pairs are DE's (:func:`~..ops.de_kernel.de_pairs`): in roll mode
``s1 = int(u1 * nc)`` and ``d = 1 + int(u2 * (nc - 1))`` from the split's
``ROLL_LANE`` words 0 and 1 (JAX takes the two uniforms as Phi of two
normals), in random mode two picks from the ``PAIR_BLOCK`` counter.  The
amplitude ``z`` is the walker's Box-Muller normal on words 0 and 2 at
``(walker, split)``, as K5a's.  K5a's rung axis lets
:meth:`~.red_blue.RedBlueMove.propose_rungs` propose every rung of a
tempered ladder in one launch a split.
"""

from __future__ import annotations

import numpy as np

from ..ops import de_kernel
from .red_blue import RedBlueMove

__all__ = ["SideMove"]


class SideMove(RedBlueMove):
    """Gaussian-amplitude ensemble-difference proposal.

    Args:
        sigma: amplitude scale; default ``2.38 / sqrt(ndim)`` at proposal
            time.
        pair_mode: ``"random"`` per-walker pair draws or ``"roll"``.
    """

    tunable = True
    rung_batched = True

    def __init__(self, sigma=None, pair_mode="random", **kwargs):
        self.sigma = sigma
        if pair_mode not in ("random", "roll"):
            raise ValueError(f"unknown pair_mode: {pair_mode!r}")
        self.pair_mode = pair_mode
        super().__init__(**kwargs)

    def _sigma(self, gndim):
        if self.sigma is not None:
            return self.sigma
        return 2.38 / float(np.sqrt(gndim))

    def get_proposal(self, rng, coords, split, model, extra=None,
                     scale=None):
        """K5a's side mode for group ``split``.  ``extra`` injects the
        draws as a dict: ``z`` ``(ng,)`` and ``u_shift`` ``(2,)`` (roll) or
        ``idx_a``, ``idx_b`` ``(ng,)`` (random; the raw picks, before
        ``j`` is moved past ``i``); on the rung axis (``coords`` ``(T,
        nwalkers, ndim)``, ``rng``'s seed a :class:`~..ops.philox.
        RungKeys`) one row of each per rung."""
        seed, offset = rng
        return de_kernel.de_propose(
            coords, split, self.nsplits,
            gamma0=self._sigma(model.global_ndim(coords.shape[-1])),
            scale=scale, pair_mode=self.pair_mode, seed=seed, offset=offset,
            mode="side", **(extra or {}),
        )
