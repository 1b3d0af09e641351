"""What every kernel wrapper shares: its argument checks, the complement
row map, the Philox key and offset arguments, the launch plans of K1 and
K2 (``tile_plan``), of K2's rung axis (``rung_plan``) and of K5a and K5b
(``de_plan``), and the launch on the current stream.

A wrapper checks device, type, shape and contiguity before it launches,
and raises on what its kernel does not take; the launch returns the C
entry point's ``cudaGetLastError()``, and a refused launch raises here.
The checks run on the host when a wrapper is called: once per recording
when the call is recorded into a CUDA graph, never per replay.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .philox import DeviceOffset, RungKeys

_MASK64 = 0xFFFFFFFFFFFFFFFF

#: the largest tile of K1 and K2, and K2's threads per block (kThreads /
#: kTileMax in csrc/accept_select.cu and csrc/stretch_propose.cu)
TILE_MAX = 256
#: the smallest tile: 4 walkers, so that every tile's span of rows starts
#: a multiple of 4 floats after the split's first row
TILE_MIN = 4
#: the plan's grid has at least this many blocks for every SM where the
#: split allows it
BLOCKS_PER_SM = 2
#: shared memory a block may use without an opt-in attribute
SMEM_LIMIT = 48 * 1024
#: an upper bound on the static shared memory of K1, K2, K5a and K5b
#: (per-walker arrays of at most 3 x TILE_MAX words, shift words, an
#: mbarrier)
STATIC_SMEM = 4096
#: K5a's and K5b's grid has at least this many blocks for every SM where
#: the split allows it (the fastest tile of a sweep at workload 3's shape,
#: PERF.md)
K5_BLOCKS_PER_SM = 4
#: K5a's threads per block (one warp more where the tile needs it:
#: csrc/de_propose.cu kThreadsMax)
DE_THREADS = 256
#: the largest tile of K5b, which has one warp per walker (kTileMax in
#: csrc/snooker_propose.cu)
SNOOKER_TILE_MAX = 16

#: K2's rung kernel's block.  On the H100, in workload 4's replays (16
#: rungs x 128 walkers), blocks of 32-256 were within 0.06 us of each
#: other, 128 among the fastest (PERF.md)
RUNG_THREADS = 128
#: the largest block the rung kernel takes (kRungThreads in
#: csrc/accept_select.cu), for plans forced by a sweep
RUNG_THREADS_LIMIT = 512
#: the floats of a q row that K2's rung kernel loads into registers before
#: the decision (kRowRegs); longer rows are copied after it
RUNG_ROW_REGS = 8

#: pair mode name -> the kernels' code for it
PAIR_MODES = {"roll": 0, "random": 1}


def ptr(t):
    """A tensor's device pointer, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def check_f32(name, t, device, shape=None):
    """A contiguous float32 tensor on ``device`` (of ``shape``), or None."""
    if t is None:
        return
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(
            f"{name} must be float32 on {device}, got {t.dtype} on "
            f"{t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")


def check_i32(name, t, device, shape):
    if (t.device != device or t.dtype != torch.int32
            or not t.is_contiguous() or tuple(t.shape) != shape):
        raise ValueError(f"{name} must be a contiguous {shape} int32 tensor "
                         f"on {device}")


def check_rows(coords, split, nsplits, min_splits=2, rungs=False):
    """The ensemble buffer and split as the kernels take them; returns
    ``(nwalkers, ndim, ng)``.  The proposal kernels need a complement,
    so two splits or more; K2 needs none and takes ``min_splits=1`` (the
    whole ensemble as one split, as ``MHMove`` proposes it).  With
    ``rungs`` the buffer may also be ``(T, nwalkers, ndim)`` (the rung
    axis of K1, K2, K5a and K5b)."""
    if coords.dim() == 3 and rungs:
        if coords.shape[0] < 1 or coords.shape[0] >= 65536:
            raise ValueError("the rung axis holds 1 to 65535 rungs")
        if coords.numel() >= 2**31:
            raise ValueError("ensemble too large for int32 indexing")
        nw, nd, ng = check_rows(coords[0], split, nsplits, min_splits)
        check_f32("coords", coords, coords.device)
        return nw, nd, ng
    if coords.dim() != 2:
        raise ValueError("coords must be (nwalkers, ndim)"
                         + (" or (ntemps, nwalkers, ndim)" if rungs else ""))
    nw, nd = coords.shape
    if (nsplits < min_splits or nw % nsplits
            or not 0 <= split < nsplits):
        raise ValueError(f"bad split {split} of {nsplits} for {nw} walkers")
    if nw * nd >= 2**31:
        raise ValueError("ensemble too large for int32 indexing")
    check_f32("coords", coords, coords.device)
    return nw, nd, nw // nsplits


def check_pair_mode(pair_mode):
    if pair_mode not in PAIR_MODES:
        raise ValueError(f"unknown pair_mode: {pair_mode!r}")


class TilePlan(NamedTuple):
    """How K1 and K2 cut a split into blocks; the fields are the C entry
    points' arguments, in this order."""

    tile: int  #: consecutive walkers per block
    grid: int  #: blocks, ``ceil(ng / tile)``
    vec: int  #: 1: every tile's rows in ``coords`` and in ``q`` are 16-byte aligned spans
    stage: int  #: 1: K2 bulk-copies each tile's ``q`` span to shared memory
    smem: int  #: dynamic shared memory per block, bytes


@functools.cache
def sm_count(index):
    """The number of SMs of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_sm_count(device):
    index = device.index
    return sm_count(torch.cuda.current_device() if index is None else index)


def tile_plan(ng, nd, split, n_sm, coords_ptr, q_ptr, stage=False, rungs=1,
              nsplits=1):
    """The launch plan of K1 or K2 for block ``split`` of ``ng`` walkers
    of ``nd`` floats on a card of ``n_sm`` SMs, with ``coords`` and ``q``
    at byte addresses ``coords_ptr`` and ``q_ptr``.

    The tile is the largest power of two from ``TILE_MAX`` down to
    ``TILE_MIN`` whose grid still has ``BLOCKS_PER_SM`` blocks for every
    SM (and, when ``stage`` asks for ``q`` in shared memory, whose ``q``
    span fits beside the static arrays under ``SMEM_LIMIT``; staging is
    dropped where even ``TILE_MIN`` rows do not fit).  On the H100 that
    gives 128 walkers at ndim 5 (ng 50000, 391 blocks) and 16 at ndim 100
    (ng 5000, 313 blocks), the fastest tiles of a sweep over 16-256 for
    both kernels at both shapes (``PERF.md``).  Tile ``b`` holds walkers
    ``[b*tile, min((b+1)*tile, ng))``; its rows are the ``coords`` floats
    from ``(split*ng + b*tile)*nd`` and the ``q`` floats from
    ``b*tile*nd``, so both spans of every tile start 16-byte aligned
    exactly when both bases are and ``split*ng*nd % 4 == 0`` (``tile*nd``
    is a multiple of 4): that is ``vec``.  Staging takes a 16-byte
    aligned ``q`` base (a bulk copy's source).

    With ``rungs`` > 1 (the rung axis: ``rungs`` ensembles of ``nsplits *
    ng`` walkers one after the other in ``coords``, ``rungs`` blocks of
    ``ng`` rows in ``q``) the grid's blocks of every rung count toward
    filling the card, and ``vec`` and ``stage`` also need every rung's
    base aligned: ``nsplits * ng * nd`` (``coords``) and ``ng * nd``
    (``q``) multiples of 4."""
    cap = TILE_MAX
    rung_ok = rungs == 1 or ng * nd % 4 == 0
    if stage:
        fit = (SMEM_LIMIT - STATIC_SMEM) // (4 * nd)
        stage = fit >= TILE_MIN and q_ptr % 16 == 0 and rung_ok
        while stage and cap > fit:
            cap //= 2
    tile = cap
    while (tile > TILE_MIN
           and rungs * -(-ng // tile) < BLOCKS_PER_SM * n_sm):
        tile //= 2
    vec = (coords_ptr % 16 == 0 and q_ptr % 16 == 0
           and split * ng * nd % 4 == 0 and rung_ok
           and (rungs == 1 or nsplits * ng * nd % 4 == 0))
    return TilePlan(tile, -(-ng // tile), int(vec), int(stage),
                    4 * tile * nd if stage else 0)


def divisor(k):
    """``(mul, shr)`` with ``((t * mul) >> 32) >> shr == t // k`` for
    every ``0 <= t < 2**31`` (``1 <= k < 2**31``): ``mul = ceil(2**p / k)``
    with ``p = 31 + ceil(log2 k)``, ``shr = p - 32``.  The error of the
    rounded-up ``mul`` adds less than ``t / 2**p < 2**-ceil(log2 k) <=
    1 / k`` to ``t / k``, too little to reach the next integer.  ``k = 1``
    gives ``(0, 0)``: the kernels take ``t`` itself.  K14 divides its
    thread's index so, by the counters of a rung and of a row."""
    if not 1 <= k < 1 << 31:
        raise ValueError(f"k must be in [1, 2**31), got {k}")
    if k == 1:
        return 0, 0
    p = 31 + (k - 1).bit_length()
    return -(-(1 << p) // k), p - 32


class RungPlan(NamedTuple):
    """How K2's rung kernel is launched; ``threads`` and ``reg_row`` are
    the C entry point's plan arguments."""

    threads: int  #: walkers a block, one a thread, a multiple of 32
    grid: int  #: blocks a rung, ``ceil(ng / threads)``
    reg_row: int  #: 1: each walker's q row goes through registers


def rung_plan(ng, nd):
    """The launch plan of K2 with the rung axis for ``ng`` walkers a split
    of ``nd`` floats: blocks of ``RUNG_THREADS``, one thread a walker,
    block ``(b, r)`` holding walkers ``[b * threads, min((b + 1) *
    threads, ng))`` of rung ``r``'s split.  A q row of up to
    ``RUNG_ROW_REGS`` floats is loaded into registers with the rest
    before the decision (``reg_row``); a longer one is copied by the
    accepted walker's thread after it."""
    return RungPlan(RUNG_THREADS, -(-ng // RUNG_THREADS),
                    int(nd <= RUNG_ROW_REGS))


class DEPlan(NamedTuple):
    """How K5a and K5b cut a split into blocks; the fields are the C entry
    points' arguments, in this order (K5b takes the first four)."""

    tile: int  #: consecutive walkers per block
    grid: int  #: blocks, ``ceil(ng / tile)``
    threads: int  #: threads per block
    vec: int  #: 1: ``ndim % 4 == 0`` and both bases 16-byte aligned (every row is)
    stage: int  #: 1: K5a bulk-copies each tile's own rows to shared memory
    smem: int  #: dynamic shared memory per block, bytes


def de_plan(ng, nd, split, n_sm, coords_ptr, q_ptr, snooker=False,
            stage=False, rungs=1, nsplits=1):
    """The launch plan of K5a (or K5b, ``snooker``) for block ``split`` of
    ``ng`` walkers of ``nd`` floats on a card of ``n_sm`` SMs, with
    ``coords`` and ``q`` at byte addresses ``coords_ptr`` and ``q_ptr``.

    The tile is the largest power of two from the cap (``TILE_MAX`` for
    K5a, ``SNOOKER_TILE_MAX`` for K5b) down to ``TILE_MIN`` whose grid
    still has ``K5_BLOCKS_PER_SM`` blocks for every SM: 8 at workload 3's
    shape (ng 5000, ndim 100, 625 blocks) for both, the fastest tile of
    a sweep over 4-64 on the H100 (``PERF.md``).  K5a's block has ``DE_THREADS``
    threads, or one warp more than the tile where that is more; its last
    warp's first lane makes the roll draw.  K5b's block has one warp per
    walker.  ``vec``: the partner rows of both kernels start at arbitrary
    rows, so every row must be 16-byte aligned: ``ndim % 4 == 0`` and both
    bases aligned.  ``stage`` (K5a only, where asked): each tile's own
    rows, the ``coords`` floats from ``(split*ng + b*tile)*nd``, are
    bulk-copied to shared memory; that takes a 16-byte aligned ``coords``
    base and ``split*ng*nd % 4 == 0`` (``tile*nd`` is a multiple of 4),
    and a span that fits beside the static arrays under ``SMEM_LIMIT``
    (the tile is halved until it does; staging is dropped where even
    ``TILE_MIN`` rows do not fit).

    With ``rungs`` > 1 (the rung axis: ``rungs`` ensembles of ``nsplits *
    ng`` walkers one after the other in ``coords``) the grid's blocks of
    every rung count toward filling the card, and ``stage`` also needs
    every rung's own rows aligned: ``nsplits * ng * nd`` a multiple of 4
    (``vec``'s ``ndim % 4 == 0`` already aligns every rung)."""
    cap = SNOOKER_TILE_MAX if snooker else TILE_MAX
    stage = (stage and not snooker and coords_ptr % 16 == 0
             and split * ng * nd % 4 == 0
             and (rungs == 1 or nsplits * ng * nd % 4 == 0))
    if stage:
        fit = (SMEM_LIMIT - STATIC_SMEM) // (4 * nd)
        stage = fit >= TILE_MIN
        while stage and cap > fit:
            cap //= 2
    tile = cap
    while (tile > TILE_MIN
           and rungs * -(-ng // tile) < K5_BLOCKS_PER_SM * n_sm):
        tile //= 2
    threads = (32 * tile if snooker
               else max(DE_THREADS, 32 * -(-tile // 32) + 32))
    vec = nd % 4 == 0 and coords_ptr % 16 == 0 and q_ptr % 16 == 0
    return DEPlan(tile, -(-ng // tile), threads, int(vec), int(stage),
                  4 * tile * nd if stage else 0)


def complement_rows(r, split, ng):
    """Complement index -> ensemble row: skip block ``split``'s rows, as
    the kernels do in place (``r + (r >= split*ng)*ng``)."""
    return torch.where(r >= split * ng, r + ng, r)


def rng_args(seed, offset, device):
    """The kernels' last three arguments before the stream: the 64-bit
    seed, the device offset word's pointer (None for an int offset) and
    the increment added to it."""
    if isinstance(offset, DeviceOffset):
        w = offset.word
        if w.device != device or w.dtype != torch.int64 or w.dim() != 0:
            raise ValueError(f"the offset word must be a 0-d int64 tensor "
                             f"on {device}")
        return int(seed) & _MASK64, w.data_ptr(), int(offset.inc) & _MASK64
    return int(seed) & _MASK64, None, int(offset) & _MASK64


def key_args(seed, device, ntemps, injected=False):
    """The kernels' rung key arguments ``(ntemps, key table pointer,
    seed)`` for ``seed``: an int (one ensemble, or rungs whose draws are
    all injected) or a :class:`~.philox.RungKeys` of ``ntemps`` rungs,
    whose table the kernel reads on ``device``."""
    if isinstance(seed, RungKeys):
        t = seed.table
        if (t.device != device or t.dtype != torch.int64
                or tuple(t.shape) != (ntemps,)):
            raise ValueError(f"the rung key table must be a ({ntemps},) "
                             f"int64 tensor on {device}")
        return ntemps, t.data_ptr(), int(seed.seed) & _MASK64
    if ntemps > 1 and not injected:
        raise ValueError("rungs that draw their own numbers need their "
                         "keys as a RungKeys (ops/philox.py rung_keys)")
    return ntemps, None, int(seed) & _MASK64


def launch(name, device, *args):
    """Call kernel ``name``'s C entry point with ``args`` and the current
    stream of ``device``; raise if the launch was refused."""
    from ._build import library

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = library(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def count_launches(fn, n=1):
    """Add ``n`` launches of wrapper ``fn``'s kernel to its counts: to
    ``fn.launches`` on the host and, while a caller has set
    ``fn.device_launches`` to a 0-d int64 tensor on the card, to that word
    on the current stream.  A CUDA graph recorded meanwhile holds the add
    beside the launch, so the word counts every replayed launch too; the
    host count sees recordings and eager calls only."""
    fn.launches += n
    if fn.device_launches is not None:
        fn.device_launches.add_(n)
