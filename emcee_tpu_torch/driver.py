"""Driver plumbing: move schedules, thinning and chunk scheduling.

The counterpart of ``emcee_tpu/driver.py``: ``shim_thin`` (``:32``),
``parse_moves`` (``:140``) and ``chunk_schedule`` (``:174-212``), plus
the move choice of a weighted list, per proposal or per
``mixture_block`` block, drawn from the port's Philox stream on the host
(no device work, no sync).
"""

from __future__ import annotations

import warnings

import numpy as np

from .ops.philox import MOVE_BLOCK, MOVE_LANE, uniform_scalar

__all__ = ["choose_move", "chunk_schedule", "parse_moves", "shim_thin"]


def shim_thin(n, thin):
    """Map the deprecated ``thin=`` argument (counts *proposals*) onto
    ``(kept, thin_by)``; ``n`` not divisible by ``thin`` rounds down."""
    warnings.warn(
        "the 'thin' argument is deprecated; use 'thin_by' (which "
        "counts kept steps, not proposals) instead; note n not "
        "divisible by thin rounds down to (n // thin) * thin "
        "proposals, and generators yield once per KEPT step",
        DeprecationWarning,
        stacklevel=3,
    )
    thin = int(thin)
    if thin <= 0:
        raise ValueError("Invalid thinning argument")
    return (None if n is None else int(n) // thin), thin


def parse_moves(moves, default_move_factory):
    """Parse a move schedule into ``(moves, normalized_weights)``.

    Accepts a single move, a list of moves, or a weighted
    ``[(move, weight), ...]`` list (reference ``ensemble.py:115-129``).
    """
    if moves is None:
        return [default_move_factory()], np.array([1.0])
    if hasattr(moves, "propose"):
        return [moves], np.array([1.0])
    moves = list(moves)
    if all(hasattr(m, "__len__") and len(m) == 2 for m in moves):
        parsed, w = map(list, zip(*moves))
        weights = np.asarray(w, dtype=float)
    else:
        parsed = moves
        weights = np.ones(len(moves))
    if np.any(weights < 0):
        raise ValueError("Move weights must be non-negative")
    if np.sum(weights) == 0:
        raise ValueError("At least one move must have a positive weight")
    return parsed, weights / np.sum(weights)


def choose_move(weights, seed, offset, block=False):
    """Index of the move that proposal ``offset`` runs: the weighted
    choice by the uniform at counter ``(MOVE_LANE, 0, offset)``.  With
    ``block``, the choice of a ``mixture_block`` block whose first
    proposal is ``offset``, from its own counter ``(MOVE_LANE,
    MOVE_BLOCK, offset)``."""
    if len(weights) == 1:
        return 0
    u = uniform_scalar(seed, MOVE_LANE, MOVE_BLOCK if block else 0, offset)
    idx = int(np.searchsorted(np.cumsum(weights), u, side="right"))
    return min(idx, len(weights) - 1)


def _schedule_sizes(nsteps, max_chunk):
    """Split ``nsteps`` into chunk sizes, preferring an equal divisor of
    ``nsteps`` close to ``max_chunk``."""
    if nsteps <= max_chunk:
        return [nsteps]
    for d in range(max_chunk, max(1, max_chunk // 2), -1):
        if nsteps % d == 0:
            return [d] * (nsteps // d)
    sizes = [max_chunk] * (nsteps // max_chunk)
    if nsteps % max_chunk:
        sizes.append(nsteps % max_chunk)
    return sizes


def chunk_schedule(nsteps, max_chunk, mixture_block=1):
    """Chunk sizes for ``nsteps`` kept steps.

    With an active ``mixture_block`` (> 1) the chunks are whole multiples
    of the block, so the blocked move choice engages (a chunk that is not
    a multiple falls back to one choice per proposal); at most one ragged
    tail chunk takes the fallback.  When ``max_chunk`` allows fewer kept
    steps than one block, a chunk still holds one whole block.
    """
    blk = int(mixture_block)
    if blk > 1:
        nb, rem = divmod(nsteps, blk)
        if nb == 0:
            return [nsteps]
        sizes = [s * blk
                 for s in _schedule_sizes(nb, max(1, max_chunk // blk))]
        if rem:
            sizes.append(rem)
        return sizes
    return _schedule_sizes(nsteps, max_chunk)
