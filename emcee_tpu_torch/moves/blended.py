"""Blended red-blue move: a weighted mixture fused into one proposal.

The counterpart of ``emcee_tpu/moves/blended.py:34-120``: per split,
every sub-move's proposal is computed, one is chosen by a categorical
draw over the weights, and one shared log-prob evaluation and
accept/select (K2) follow.  Over the workload-3 pair

    BlendedMove([
        (DEMove(pair_mode="roll"), 0.8),
        (DESnookerMove(pair_mode="roll", nsplits=2), 0.2),
    ], randomize_split=False)

K5a and K5b both launch in each split, and K20 (``ops/blend_kernel.py``,
``csrc/blend_select.cu``) draws the split's choice and copies the chosen
``q`` and factor, so the choice never reaches the host.

The choice of split ``j`` is an inverse CDF of the uniform at
``(ROLL_LANE, BLEND_BLOCK | j, offset)``, drawn inside K20's launch of the
split.  Sub-move ``k`` draws at the proposal's offset under a key of its
own (:func:`~..ops.philox.sub_seed`), as the JAX package gives each its
own ``split(key, n + 1)`` stream.
``mode="switch"`` computes every sub-proposal too (the same draws give
the same ``q``; skipping the unchosen one is a later optimisation).

The rung axis: the blend is ``rung_batched`` when every sub-move is
(every blendable move is), so a ladder proposes every rung at once
through :meth:`~.red_blue.RedBlueMove.propose_rungs`.  Each sub-move's
proposal then runs on the ``(T, ng, d)`` rows under its sub-move keys
(:func:`~..ops.philox.sub_keys`: rung ``r``'s key ``sub_seed(rung_seed(
seed, r), k)``, so rung 0's is the one-ensemble stream; the tables are
made once per ladder, on the host), and one K20 launch picks each rung's
own choice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import blend_kernel
from ..ops.philox import RungKeys, sub_keys, sub_seed
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
        # The sub-moves' key tables of a ladder, per (rungs' keys, device):
        # made at the first (eager) proposal, so a recorded proposal copies
        # nothing from the host.
        self._keys = {}

    @property
    def rung_batched(self):
        """True when every sub-move proposes every rung at once."""
        return all(m.rung_batched for m in self._moves)

    def choice(self, u):
        """The sub-move index of uniforms ``u``: the inverse CDF of the
        weights, on ``u``'s device (the choice K20 makes)."""
        return blend_kernel.blend_choice(u, self._cdf)

    def _sub_seeds(self, seed):
        """Each sub-move's key under ``seed``: an int, or on the rung axis
        a :class:`~..ops.philox.RungKeys` of every rung's sub-move key."""
        if not isinstance(seed, RungKeys):
            return [sub_seed(seed, k) for k in range(len(self._moves))]
        key = (seed.seeds, str(seed.table.device))
        if key not in self._keys:
            self._keys[key] = [sub_keys(seed, k)
                               for k in range(len(self._moves))]
        return self._keys[key]

    def get_proposal(self, rng, coords, split, model, extra=None,
                     scale=None):
        """Every sub-move's proposal of group ``split``, one selected by
        K20 (``coords`` ``(nw, d)``, or ``(T, nw, d)`` under the rungs'
        keys).  ``extra`` injects the choice (an int or a ``()`` / ``(T,)``
        int64 tensor) or the draws as a dict: ``choice`` and ``moves``, a
        list of each sub-move's ``extra``."""
        if not isinstance(extra, dict):
            extra = {"choice": extra}
        seed, offset = rng
        idx = extra.get("choice")
        if isinstance(idx, torch.Tensor):
            idx = idx.to(device=coords.device, dtype=torch.int64)
        subs = extra.get("moves") or [None] * len(self._moves)
        qs, fs = [], []
        for m, key, sub in zip(self._moves, self._sub_seeds(seed), subs):
            qk, fk = m._split_proposal((key, offset), coords, split, model,
                                       extra=sub)
            qs.append(qk.contiguous())
            fs.append(fk.contiguous())
        return blend_kernel.blend_select(qs, fs, self._cdf, seed, offset,
                                         split, idx)
