"""Blended red-blue move: a weighted mixture fused into one proposal.

The counterpart of ``emcee_tpu/moves/blended.py:34-120``: per split,
every sub-move's proposal is computed, one is chosen by a categorical
draw over the weights, and one shared log-prob evaluation and
accept/select (K2) follow.  Over the workload-3 pair

    BlendedMove([
        (DEMove(pair_mode="roll"), 0.8),
        (DESnookerMove(pair_mode="roll", nsplits=2), 0.2),
    ], randomize_split=False)

K5a and K5b both launch in each split and one ``q`` is selected on the
device (``torch.where``), so the choice never reaches the host.

The choice of split ``j`` is an inverse CDF of the uniform at
``(ROLL_LANE, BLEND_BLOCK | j, offset)``; every split's is drawn in one
plain Philox call before the splits (a Philox of one counter is ~100
small kernels however many counters it holds).  Sub-move ``k`` draws at
the proposal's offset under a key of its own
(:func:`~..ops.philox.sub_seed`), as the JAX package gives each its own
``split(key, n + 1)`` stream.
``mode="switch"`` computes every sub-proposal too (the same draws give
the same ``q``; skipping the unchosen one is a later optimisation).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.philox import BLEND_BLOCK, ROLL_LANE, sub_seed, word_uniforms
from .red_blue import RedBlueMove

__all__ = ["BlendedMove"]


class BlendedMove(RedBlueMove):
    """Fused weighted mixture of red-blue moves.

    Args:
        moves: ``[(move, weight), ...]`` (or a plain list for equal
            weights).  Every move must be a :class:`RedBlueMove` with the
            same ``nsplits``.
        mode: ``"select"`` (default) or ``"switch"``.
        randomize_split / live_dangerously: as for any red-blue move
            (the split is owned by the blend).
    """

    def __init__(self, moves, mode="select", **kwargs):
        if mode not in ("select", "switch"):
            raise ValueError(f"unknown mode: {mode!r}")
        self.mode = mode
        moves = list(moves)
        if all(hasattr(m, "__len__") and len(m) == 2 for m in moves):
            self._moves, w = map(list, zip(*moves))
            weights = np.asarray(w, dtype=float)
        else:
            self._moves = moves
            weights = np.ones(len(moves))
        if len(self._moves) < 2:
            raise ValueError("BlendedMove needs at least two moves")
        for m in self._moves:
            if not isinstance(m, RedBlueMove):
                raise ValueError(
                    "BlendedMove blends red-blue moves only; got "
                    f"{type(m).__name__}"
                )
            if not m.blendable:
                raise ValueError(
                    f"{type(m).__name__} cannot be blended: its update "
                    "is not a (q, factors) proposal sharing one "
                    "log-prob evaluation — use it in a sampler-level "
                    "move mixture instead"
                )
        nsplits = {m.nsplits for m in self._moves}
        if len(nsplits) != 1:
            raise ValueError(
                f"all blended moves must share nsplits; got {nsplits}"
            )
        if np.any(weights < 0) or weights.sum() == 0:
            raise ValueError("invalid mixture weights")
        self._weights = weights / weights.sum()
        # The choice is the count of these CDF points at or below u.
        self._cdf = [float(c) for c in np.cumsum(self._weights)[:-1]]
        kwargs.setdefault("nsplits", nsplits.pop())
        super().__init__(**kwargs)

    def choice(self, u):
        """The sub-move index of uniforms ``u``: the inverse CDF of the
        weights, on ``u``'s device."""
        idx = torch.zeros(u.shape, dtype=torch.int64, device=u.device)
        for c in self._cdf:
            idx = idx + (u >= c).to(torch.int64)
        return idx

    def _split_draws(self, rng, device):
        """Every split's choice, ``(nsplits,)`` int64, from one Philox
        call over the counters ``(ROLL_LANE, BLEND_BLOCK | split)``."""
        seed, offset = rng
        u = word_uniforms(1, self.nsplits, BLEND_BLOCK, seed, offset, device,
                          row0=ROLL_LANE)[0]
        return self.choice(u)

    def get_proposal(self, rng, coords, split, model, extra=None,
                     scale=None):
        """Every sub-move's proposal of group ``split``, one selected.
        ``extra`` is the split's choice (a 0-d tensor, from the engine),
        or injects the draws as a dict: ``choice`` (an int or a 0-d
        tensor) and ``moves``, a list of each sub-move's ``extra``."""
        if not isinstance(extra, dict):
            extra = {"choice": extra}
        seed, offset = rng
        dev = coords.device
        ng = coords.shape[0] // self.nsplits
        idx = extra.get("choice")
        if idx is None:
            idx = self._split_draws(rng, dev)[split]
        idx = torch.as_tensor(idx, device=dev)
        subs = extra.get("moves") or [None] * len(self._moves)
        q = factors = None
        for k, (m, sub) in enumerate(zip(self._moves, subs)):
            qk, fk = m.get_proposal((sub_seed(seed, k), offset), coords,
                                    split, model, extra=sub)
            fk = fk.expand(ng)
            if q is None:
                q, factors = qk, fk
            else:
                pick = idx == k
                q = torch.where(pick, qk, q)
                factors = torch.where(pick, fk, factors)
        return q, factors
