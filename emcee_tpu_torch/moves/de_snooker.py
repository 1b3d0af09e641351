"""Snooker differential-evolution move (Ter Braak & Vrugt 2008).

The counterpart of ``emcee_tpu/moves/de_snooker.py:41-139``: for each
walker three points of the other split groups take the roles
``(z, z1, z2)``; the proposal moves along ``u = (s - z) / |s - z|``,
``q = s + gammas * u * (u . (z1 - z2))``, with the Metropolis factor
``(ndim - 1) * (log|q - z| - log|s - z|)``.  Both pair modes run through
K5b (``ops/snooker_kernel.py``):

* ``pair_mode="random"`` (reference-faithful, ``nsplits=4``): one uniform
  member of each other group per walker and a per-walker role
  permutation;
* ``pair_mode="roll"``: each pick is ``c[(i + shift) % n]`` under one
  random shift per pick and split, and one role permutation per split;
  with ``nsplits=2`` the three picks are three shifts of the one
  complement and keep their order.

K5b's rung axis lets :meth:`~.red_blue.RedBlueMove.propose_rungs` propose
every rung of a tempered ladder in one launch a split.
"""

from __future__ import annotations

from ..ops import snooker_kernel
from .red_blue import RedBlueMove

__all__ = ["DESnookerMove"]


class DESnookerMove(RedBlueMove):
    """Snooker DE proposal.

    Args:
        gammas: mean stretch factor (default 1.7, as the reference).
        pair_mode: ``"random"`` (default) or ``"roll"``.
        nsplits: 4 (default, as the reference), or 2 with
            ``pair_mode="roll"``.
    """

    tunable = True
    rung_batched = True

    def __init__(self, gammas=1.7, pair_mode="random", **kwargs):
        self.gammas = float(gammas)
        if pair_mode not in ("random", "roll"):
            raise ValueError(f"unknown pair_mode: {pair_mode!r}")
        self.pair_mode = pair_mode
        kwargs.setdefault("nsplits", 4)
        if kwargs["nsplits"] != 4 and not (
            pair_mode == "roll" and kwargs["nsplits"] == 2
        ):
            raise ValueError(
                "DESnookerMove needs nsplits=4 (or 2 with pair_mode='roll')"
            )
        super().__init__(**kwargs)

    def get_proposal(self, rng, coords, split, model, extra=None,
                     scale=None):
        """K5b for group ``split``.  ``extra`` injects the draws: the
        ``(4,)`` roll uniforms (the JAX package's layout) in roll mode, a
        dict with ``idx`` and ``perm`` in random mode; on the rung axis
        (``coords`` ``(T, nwalkers, ndim)``, ``rng``'s seed a
        :class:`~..ops.philox.RungKeys`) one row of them per rung."""
        if extra is None:
            extra = {}
        elif self.pair_mode == "roll":
            extra = {"u4": extra}
        seed, offset = rng
        return snooker_kernel.snooker_propose(
            coords, split, self.nsplits, gammas=self.gammas, scale=scale,
            ndim_global=model.global_ndim(coords.shape[-1]),
            pair_mode=self.pair_mode, seed=seed, offset=offset, **extra,
        )
