"""Gaussianized difference ("side") move.

The counterpart of ``emcee_tpu/moves/side.py:33-85``: the walker steps
along the difference of two complement members with a Gaussian
amplitude, ``q = s + (sigma / sqrt(2)) * z * (c_j - c_i)``, ``z ~ N(0,
1)``, ``sigma = 2.38 / sqrt(ndim)`` by default; the Hastings factor is
zero (``z`` is sign-symmetric and the pair exchangeable).  Plain torch;
each split's accept/select is K2.

The pairs are DE's (``ops/de_kernel.py`` :func:`~..ops.de_kernel.
de_pairs`): in roll mode ``s1 = int(u1 * nc)`` and ``d = 1 + int(u2 *
(nc - 1))`` from the split's ``ROLL_LANE`` words 0 and 1 (JAX takes the
two uniforms as Phi of two normals), in random mode two picks from the
``PAIR_BLOCK`` counter.  The amplitude ``z`` is the walker's Box-Muller
normal on words 0 and 2 at ``(walker, split)``, as K5a's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.de_kernel import de_pairs, walker_normal
from ..ops._wrap import complement_rows
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
        """The proposal of group ``split``.  ``extra`` injects the draws
        as a dict: ``z`` ``(ng,)`` and ``u_shift`` ``(2,)`` (roll) or
        ``idx_a``, ``idx_b`` ``(ng,)`` (random; the raw picks, before
        ``j`` is moved past ``i``)."""
        extra = extra or {}
        seed, offset = rng
        nw, nd = coords.shape
        ng = nw // self.nsplits
        dev, dt = coords.device, coords.dtype
        z = extra.get("z")
        if z is None:
            z = walker_normal(ng, split, seed, offset, dev, dt)
        a, b = de_pairs(ng, nw - ng, split, self.pair_mode, seed, offset,
                        dev, extra.get("u_shift"), extra.get("idx_a"),
                        extra.get("idx_b"))
        ci = coords.index_select(0, complement_rows(a, split, ng))
        cj = coords.index_select(0, complement_rows(b, split, ng))
        # (sigma / sqrt(2)) in float32, as the JAX package computes it.
        sigma = np.float32(self._sigma(model.global_ndim(nd)))
        root2 = np.float32(np.sqrt(2.0))
        coef = float(sigma / root2)
        if scale is not None:
            coef = (float(sigma) * scale) / float(root2)
        s = coords[split * ng:(split + 1) * ng]
        amp = (coef * z)[:, None]
        return s + amp * (cj - ci), torch.zeros(ng, dtype=dt, device=dev)
