"""Goodman & Weare (2010) stretch move.

The counterpart of ``emcee_tpu/moves/stretch.py:26-84``: draw ``z`` from
g(z) ∝ 1/sqrt(z) on [1/a, a] via ``z = ((a-1)U + 1)^2 / a``, pair each
walker with a member of the complement, propose ``q = c_r - (c_r - s) z``
and carry the Hastings factor ``(ndim-1) log z``.  Both pair modes run
through K1 (``ops/stretch_kernel.py``).
"""

from __future__ import annotations

from ..ops import stretch_kernel
from .red_blue import RedBlueMove

__all__ = ["StretchMove"]


class StretchMove(RedBlueMove):
    """The affine-invariant stretch move.

    Args:
        a: stretch scale parameter (default 2.0).
        pair_mode: ``"random"`` (default, reference-faithful): an
            independent uniform partner per walker.  ``"roll"``: partner
            ``c[(i + shift) % nc]`` with one uniform random shift per
            split; the partner choice is independent of the chain state,
            so detailed balance holds.
    """

    tunable = True

    def __init__(self, a=2.0, pair_mode="random", **kwargs):
        self.a = float(a)
        if pair_mode not in ("random", "roll"):
            raise ValueError(f"unknown pair_mode: {pair_mode!r}")
        self.pair_mode = pair_mode
        super().__init__(**kwargs)

    def get_proposal(self, rng, coords, split, model, extra=None,
                     scale=None):
        """K1 for group ``split``.  ``extra`` injects the uniforms:
        ``[u_z (ng), u_shift]`` in roll mode (the JAX package's layout,
        ``stretch.py:67-70``), ``[u_z (ng), u_pair (ng)]`` in random
        mode."""
        ng = coords.shape[0] // self.nsplits
        u_z = u_pair = u_shift = None
        if extra is not None:
            u_z = extra[:ng]
            if self.pair_mode == "roll":
                u_shift = extra[ng]
            else:
                u_pair = extra[ng:2 * ng]
        seed, offset = rng
        # The Hastings factor uses the global ndim (stretch.py:82).
        return stretch_kernel.stretch_propose(
            coords, split, self.nsplits, a=self.a, scale=scale,
            ndim_global=model.global_ndim(coords.shape[1]),
            pair_mode=self.pair_mode, seed=seed, offset=offset,
            u_z=u_z, u_pair=u_pair, u_shift=u_shift,
        )
