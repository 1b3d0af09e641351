"""Driver plumbing: move schedules, thinning, reduced-precision storage
and chunk scheduling.

The counterpart of ``emcee_tpu/driver.py``: ``shim_thin`` (``:32``),
``grow_blobs_template`` (``:68-80``), ``parse_moves`` (``:140``),
``parse_io_dtype`` (``:164-171``) and ``chunk_schedule``
(``:174-212``), plus
the move choice of a weighted list, per proposal or per
``mixture_block`` block, drawn from the port's Philox stream on the host
(no device work, no sync), and :func:`chunk_replays`, which turns a
chunk into the host-known runs of one move that the chunk program
(``chunk_graph.py``) replays.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .ops.philox import (
    MASK32, MOVE_BLOCK, MOVE_LANE, philox4x32, split_key, uniform_scalar)
from .utils import tree_map

__all__ = ["choose_move", "chunk_replays", "chunk_schedule",
           "grow_blobs_template", "move_sequence", "parse_io_dtype",
           "parse_moves", "shim_thin", "stored_dtype", "torch_dtype"]


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


def torch_dtype(dt):
    """The torch dtype of a numpy dtype (or of a torch dtype)."""
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.empty(0, dtype=dt)).dtype


def parse_io_dtype(io_dtype):
    """Validate the reduced-precision storage dtype (None passes): a
    floating dtype that numpy holds too (float16, float32, float64), as
    the host backends store it.  Returns the torch dtype."""
    if io_dtype is None:
        return None
    try:
        dt = torch_dtype(io_dtype if isinstance(io_dtype, torch.dtype)
                         else np.dtype(io_dtype))
    except TypeError as err:
        raise ValueError(f"io_dtype must be a floating dtype numpy and "
                         f"torch both hold, got {io_dtype!r}") from err
    if not dt.is_floating_point or dt == torch.bfloat16:
        raise ValueError(f"io_dtype must be a floating dtype numpy and "
                         f"torch both hold, got {io_dtype!r}")
    return dt


def stored_dtype(dtype, io_dtype):
    """The dtype a blob leaf of ``dtype`` is stored in: ``io_dtype`` for
    a float leaf when it is set (the JAX package's ``cast_io``; the port
    casts in the copy into rows of this dtype)."""
    if io_dtype is not None and dtype.is_floating_point:
        return io_dtype
    return dtype


def grow_blobs_template(blobs, io_dtype):
    """Host template for ``backend.grow``: numpy empties of each blob
    leaf's shape and stored dtype (``io_dtype`` for float leaves), so no
    device work or copy runs at the start of a run."""
    if blobs is None:
        return None

    def t(leaf):
        dt = stored_dtype(leaf.dtype, io_dtype)
        return np.empty(tuple(leaf.shape),
                        dtype=torch.empty(0, dtype=dt).numpy().dtype)

    return tree_map(t, blobs)


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
    MOVE_BLOCK, offset)``.  The scalar reference of :func:`move_sequence`,
    which draws a whole chunk's choices at once."""
    if len(weights) == 1:
        return 0
    u = uniform_scalar(seed, MOVE_LANE, MOVE_BLOCK if block else 0, offset)
    idx = int(np.searchsorted(np.cumsum(weights), u, side="right"))
    return min(idx, len(weights) - 1)


def _choose_moves(weights, seed, offsets, block):
    """:func:`choose_move` for an array of offsets at once: the same
    Philox words, uniforms and weighted choice, vectorized on the host."""
    p = torch.as_tensor(np.asarray(offsets, dtype=np.int64))
    w = philox4x32(MOVE_LANE, MOVE_BLOCK if block else 0, p & MASK32,
                   (p >> 32) & MASK32, split_key(seed))[0]
    u = (w >> 8).numpy().astype(np.float64) * 2.0**-24
    idx = np.searchsorted(np.cumsum(weights), u, side="right")
    return np.minimum(idx, len(weights) - 1)


def move_sequence(weights, seed, offset, nkeep, thin_by, mixture_block=1):
    """The move index of each of a chunk's ``nkeep * thin_by`` proposals,
    the first at ``offset``, as :func:`choose_move` gives them: with
    ``mixture_block`` > 1 and ``nkeep`` a multiple of it, one choice per
    block of ``mixture_block`` kept steps (JAX ``sampler.py:829-878``);
    otherwise one per proposal.  A numpy int array."""
    n = nkeep * thin_by
    if len(weights) == 1:
        return np.zeros(n, dtype=np.int64)
    blk = int(mixture_block)
    if blk > 1 and nkeep % blk == 0:
        per = blk * thin_by
        starts = offset + np.arange(0, n, per, dtype=np.int64)
        return np.repeat(_choose_moves(weights, seed, starts, True), per)
    return _choose_moves(weights, seed,
                         offset + np.arange(n, dtype=np.int64), False)


def chunk_replays(seq, cut=None):
    """Runs ``[(move, count), ...]`` of equal moves in ``seq``, each cut
    where a multiple of ``cut`` proposals ends (a kept step, when the
    chunk is stored), so that every run lies inside one kept step."""
    seq = np.asarray(seq)
    p = np.arange(len(seq))
    new = np.ones(len(seq), dtype=bool)
    new[1:] = seq[1:] != seq[:-1]
    if cut is not None:
        new |= p % cut == 0
    starts = np.flatnonzero(new)
    ends = np.append(starts[1:], len(seq))
    return [(int(seq[a]), int(b - a)) for a, b in zip(starts, ends)]


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
