"""Philox4x32-10, the port's counter-based random stream.

The JAX package draws from threefry/rbg keys; those bits cannot be
reproduced in CUDA, so the port defines its own stream (Salmon et al.
2011, "Parallel random numbers: as easy as 1, 2, 3").  The same rounds
are written by hand in ``csrc/philox.cuh``; the kernels and the plain
versions below draw identical words for identical counters, so a kernel
can be held bit for bit against its plain version.

Stream layout (shared with the kernels):

* key: the 64-bit ``seed`` as ``(seed & 0xFFFFFFFF, seed >> 32)``;
* counter: ``(walker_index, split, offset_lo, offset_hi)``, where
  ``walker_index`` is the walker's row inside its split group and
  ``offset`` is the proposal number of the chain (advanced by one per
  proposal).  An offset is a Python int, or a :class:`DeviceOffset`: a
  0-d int64 device word plus an increment, which is how a proposal
  recorded into a CUDA graph reads the chain's counter (the graph
  advances the word, so every replay draws fresh numbers); both give the
  same words for the same value;
* word 0: the stretch ``z`` uniform; word 1: the accept uniform;
  word 2: the random-pair partner uniform; word 3 at split slot
  ``nsplits``: the sort key of the shuffled split's permutation;
* words 0 and 2, in a DE proposal (K5a): the walker's Gaussian jitter
  ``z``, by Box-Muller (:func:`box_muller`).  K1 never runs in the same
  proposal, so its use of those words does not collide;
* counter ``(walker_index, PAIR_BLOCK | split, ...)``: the random-pair
  partner uniforms of the DE and snooker moves, words 0 and 1 (DE's two
  complement picks) or 0, 1, 2 (the snooker's three picks) and 3 (the
  snooker's role permutation);
* counter ``(ROLL_LANE, split, ...)``: the split's roll draws, which K1
  computes once per block, K5a/K5b in every thread, and the plain
  versions as 0-d tensors
  (:func:`roll_uniforms`): word 0 the stretch shift; words 0 and 1 DE's
  two shifts; words 0-3 the snooker's role permutation and three shifts;
* counter ``(MOVE_LANE, 0, ...)``, word 0: the weighted-move choice of a
  proposal; ``(MOVE_LANE, 1, ...)``, word 0: the choice of a
  ``mixture_block`` block, at the offset of the block's first proposal;
  both are computed on the host (:func:`uniform_scalar`), so a chunk's
  move sequence is known before it runs;
* the MH move's function (``moves/mh.py``), the KDE move (``kde.py``),
  the Gaussian move's kernel (K19, ``csrc/gaussian_propose.cu``) and the
  walk move's kernels (K18, ``csrc/walk_propose.cu``) draw from these,
  where ``row`` is the walker's row in the proposal's ensemble buffer
  (``split * ng + i``; every walker's row with ``nsplits=1``):

  - counter ``(row, NORMAL_BLOCK | k, ...)``: standard normals ``2k``
    (words 0 and 2) and ``2k + 1`` (words 1 and 3) of the row, by
    Box-Muller (:func:`normals`): the Gaussian and walk steps and the
    KDE noise;
  - counter ``(row, PICK_BLOCK | k, ...)``: uniforms ``4k .. 4k + 3`` of
    the row (:func:`row_uniforms`): the walk move's subset picks (or an
    exact subset's sort keys);
  - word 0 at ``(walker, 0, ...)``: the Gaussian move's random dimension
    (the accept uniform, word 1, is K2's at ``nsplits=1``); word 0 at
    ``(i, split, ...)``: the KDE move's kernel centre (the stretch ``z``
    word; no stretch proposal runs in the same proposal);
  - word 0 at ``(ROLL_LANE, 0, ...)``: the Gaussian move's ``factor``
    uniform (no roll draw runs in an MH proposal);
  - word 0 at ``(j, SUBSAMPLE_BLOCK | split, ...)``: the sort key of
    complement row ``j`` for the KDE move's ``max_complement``
    subsample.

  A user's ``MHMove`` proposal may draw from :func:`normals` and
  :func:`row_uniforms`; word 1 at ``(walker, 0, ...)`` is K2's.  A
  red-blue move written outside the port (``moves/red_blue.py``) draws
  its proposal of split ``j`` under a key of its own,
  :func:`split_seed` of the chain's key and ``j`` (derived at an offset
  no chain reaches, as :func:`sub_seed`), with :func:`row_uniforms`,
  :func:`normals` or :func:`word_uniforms` over its group's rows, so no
  counter it reads is K2's.

* the extension moves (``moves/side.py``, ``blended.py``, ``de_z.py``,
  ``dime.py``, ``slice.py``) draw their normals at ``NORMAL_BLOCK``
  (above) and the rest from blocks of their own under ``EXT_BLOCK``
  (bit 27 of the split word; no other block sets it), each a range of
  split words that no other block reaches:

  - word 0 at ``(ROLL_LANE, BLEND_BLOCK | split, ...)``: the
    ``BlendedMove`` choice of a split (drawn in K20,
    ``csrc/blend_select.cu``); sub-move ``k`` draws from a key of its own
    (:func:`sub_seed`; :func:`sub_keys` on a ladder), so no counter it
    reads is the blend's or K2's;
  - ``(row, DEZ_BLOCK | k, ...)``, k = 0, 1: the DE-Z picks ``i, j, a,
    b`` and ``e``, the ``g1_prob`` jump and the snooker select;
  - ``(row, DIME_BLOCK, ...)``: DIME's kernel select, its two DE picks
    and its component draw;
  - ``(row, CHI2_BLOCK | k, ...)``: DIME's chi-square normals (integer
    ``df``) or Marsaglia-Tsang candidates (any other ``df``);
  - ``(row, SLICE_BLOCK, ...)``: the slice move's pair ``i, j``, its
    window offset and its budget split ``jL``;
  - ``(row, SHRINK_BLOCK | it, ...)``, word 0: the slice move's shrink
    uniform of iteration ``it`` (``it < 2**23``).

* the gradient moves (``moves/gradient.py``) draw their Langevin noise
  and momenta at ``NORMAL_BLOCK`` (in K11, ``csrc/langevin_step.cu``, or
  :func:`normals`), accept through K2 (word 1 at ``(walker, split)``),
  and draw a proposal's step-size jitter from word 0 at ``(ROLL_LANE,
  GRAD_BLOCK | split, ...)`` (:func:`grad_uniform`).

* parallel tempering (``parallel/tempering.py``) gives each rung of the
  ladder a key of its own (:func:`rung_seed`): rung 0's key is the
  chain's seed itself, and rung ``r > 0``'s is words 0 and 1 of the
  seed's counter ``(r, RUNG_BLOCK | 0xFFFFF, 2**32 - 1, 2**32 - 1)``, an
  offset no chain reaches, as :func:`sub_seed` derives a sub-move's.
  Each rung draws every counter above under its own key, so a rung of
  the rung-batched kernels and the same rung run alone as an ensemble
  draw the same words, and a 1-rung ladder draws exactly what an
  ``EnsembleSampler`` of the same seed draws.  The even/odd swap (K15,
  ``csrc/pt_swap.cu``) draws its accept uniform of walker ``w`` and
  pair ``(lo, lo + 1)`` from word 0 of counter ``(w, SWAP_BLOCK | lo,
  offset)`` under the chain's seed: no move of rung 0 reads a
  ``SWAP_BLOCK`` or ``RUNG_BLOCK`` counter (both are ``EXT_BLOCK``
  sub-blocks of their own), and the other rungs draw under other keys.

A uniform is ``(word >> 8) * 2**-24``: 24 random bits, in ``[0, 1)`` and
exact in float32, as ``jax.random.uniform`` draws them.

The draws below that a move reads on the card (:func:`walker_words`,
:func:`rung_words`, :func:`row_words`, :func:`normals`,
:func:`row_uniforms`, :func:`word_uniforms`, :func:`roll_uniforms`,
:func:`grad_uniform`) are K14 there, one launch a draw
(``ops/philox_kernel.py``, ``csrc/philox_draw.cu``); their plain version,
the torch rounds of :func:`philox4x32_torch`, runs on the CPU and
wherever ``plain=True`` asks for it (the plain versions of the other
kernels, so that each stays independent of K14).
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "BLEND_BLOCK",
    "CHI2_BLOCK",
    "DEZ_BLOCK",
    "DIME_BLOCK",
    "DeviceOffset",
    "EXT_BLOCK",
    "GRAD_BLOCK",
    "SHRINK_BLOCK",
    "SHRINK_MAX",
    "SLICE_BLOCK",
    "MASK32",
    "ROLL_LANE",
    "MOVE_LANE",
    "MOVE_BLOCK",
    "NORMAL_BLOCK",
    "PAIR_BLOCK",
    "PICK_BLOCK",
    "RUNG_BLOCK",
    "RungKeys",
    "SWAP_BLOCK",
    "SUBSAMPLE_BLOCK",
    "box_muller",
    "grad_uniform",
    "keys_of",
    "normals",
    "philox4x32",
    "philox4x32_scalar",
    "philox4x32_torch",
    "roll_shift",
    "roll_uniforms",
    "row_uniforms",
    "row_words",
    "rung_keys",
    "rung_seed",
    "rung_words",
    "split_key",
    "split_offset",
    "split_seed",
    "sub_keys",
    "sub_seed",
    "to_uniform",
    "uniform_scalar",
    "uniforms_scalar",
    "walker_words",
    "word_uniforms",
]

MASK32 = 0xFFFFFFFF
ROLL_LANE = 0xFFFFFFFF
MOVE_LANE = 0xFFFFFFFE
#: split slot of the mixture_block choice on MOVE_LANE
MOVE_BLOCK = 1
#: high bit of the split word: the random-pair partner counter block
PAIR_BLOCK = 0x80000000
#: split word bits of the normals of the moves of plain torch (``| k``)
NORMAL_BLOCK = 0x40000000
#: split word bits of the per-row uniforms of the moves of plain torch
PICK_BLOCK = 0x20000000
#: split word bits of the KDE move's complement subsample keys
SUBSAMPLE_BLOCK = 0x10000000
#: split word bit of the extension moves' blocks (none of the above
#: sets it); each block below is this bit, a sub-block id in bits 20-23
#: and an index below 2**20 (2**23 for SHRINK_BLOCK)
EXT_BLOCK = 0x08000000
#: the BlendedMove choice of a split (``| split``, on ROLL_LANE)
BLEND_BLOCK = EXT_BLOCK | 0x000000
#: the DE-Z move's per-row uniforms (``| k``)
DEZ_BLOCK = EXT_BLOCK | 0x100000
#: the DIME move's per-row select, picks and component uniforms
DIME_BLOCK = EXT_BLOCK | 0x200000
#: the DIME move's chi-square draws (``| k``)
CHI2_BLOCK = EXT_BLOCK | 0x300000
#: the slice move's per-row pair, offset and budget uniforms
SLICE_BLOCK = EXT_BLOCK | 0x400000
#: the gradient moves' step-size jitter (``| split``, on ROLL_LANE)
GRAD_BLOCK = EXT_BLOCK | 0x500000
#: the rungs' keys of parallel tempering (:func:`rung_seed`)
RUNG_BLOCK = EXT_BLOCK | 0x600000
#: the even/odd swap's accept uniforms (``| lo``, the pair's lower rung)
SWAP_BLOCK = EXT_BLOCK | 0x700000
#: the slice move's shrink uniforms (``| iteration``)
SHRINK_BLOCK = EXT_BLOCK | 0x800000
#: shrink iterations SHRINK_BLOCK can number
SHRINK_MAX = 1 << 23
#: 2 pi rounded to float32, as the kernels' Box-Muller uses it
TWO_PI_F32 = float(np.float32(2.0 * np.pi))

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_ROUNDS = 10


class DeviceOffset(NamedTuple):
    """The offset ``word + inc``: ``word`` is a 0-d int64 tensor on the
    walkers' device (the chain's proposal counter), ``inc`` a Python int
    fixed when the work is recorded."""

    word: torch.Tensor
    inc: int = 0


def split_key(seed: int):
    """The two 32-bit key words of a 64-bit seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & MASK32, seed >> 32


def split_offset(offset):
    """The two 32-bit counter words of a 64-bit proposal offset: Python
    ints, or 0-d int64 tensors for a :class:`DeviceOffset` (computed on
    its device, no sync)."""
    if isinstance(offset, DeviceOffset):
        v = offset.word + offset.inc
        return v & MASK32, (v >> 32) & MASK32
    offset = int(offset) & 0xFFFFFFFFFFFFFFFF
    return offset & MASK32, offset >> 32


def philox4x32_scalar(counter, key):
    """Reference Philox4x32-10 on Python ints: 4 counter words, 2 key
    words -> 4 output words."""
    c = [int(w) & MASK32 for w in counter]
    for k0, k1 in _round_keys((int(key[0]), int(key[1]))):
        p0 = _M0 * c[0]
        p1 = _M1 * c[2]
        c = [
            (p1 >> 32) ^ c[1] ^ k0,
            p1 & MASK32,
            (p0 >> 32) ^ c[3] ^ k1,
            p0 & MASK32,
        ]
    return c


def uniforms_scalar(seed, lane, split, offset):
    """The four uniforms of one counter, computed on the host (no device
    work, no sync): the roll draws and the weighted-move choice."""
    lo, hi = split_offset(offset)
    words = philox4x32_scalar((lane, split, lo, hi), split_key(seed))
    return [(w >> 8) * 2.0**-24 for w in words]


def uniform_scalar(seed, lane, split, offset, word=0):
    """One uniform of :func:`uniforms_scalar`."""
    return uniforms_scalar(seed, lane, split, offset)[word]


def _draw(plain):
    """K14's wrapper ``philox_draw`` of ``ops/philox_kernel.py`` (looked
    up at each call), or its plain version ``philox_draw_plain`` where
    ``plain`` asks for the torch rounds (the plain versions of the other
    kernels draw so, independent of K14)."""
    from . import philox_kernel

    if plain:
        return philox_kernel.philox_draw_plain
    return philox_kernel.philox_draw


def roll_uniforms(seed, split, offset, device, plain=False):
    """The four uniforms at counter ``(ROLL_LANE, split, offset)`` as a
    ``(4,)`` float32 tensor on ``device``: the split's roll draws, as the
    kernels compute them."""
    if torch.device(device).type == "cpu":
        n, words = _cpu_draw(None, split, seed, offset)
        return to_uniform(torch.stack([w[n] for w in words]))
    return _draw(plain)("uniforms", 1, None, split, seed, offset,
                        device, row0=ROLL_LANE, d=4)[0]


def grad_uniform(seed, split, offset, device, plain=False):
    """The gradient moves' jitter uniform of ``split`` (word 0 at
    ``(ROLL_LANE, GRAD_BLOCK | split, offset)``), a 0-d float32 tensor on
    ``device``, computed there (``offset`` may be a device word).  Under
    a :class:`RungKeys` ``seed``, ``(T,)``: rung ``r``'s under its own
    key, every rung from one pass."""
    u = word_uniforms(1, 1, GRAD_BLOCK | split, seed, offset, device,
                      row0=ROLL_LANE, plain=plain)
    return u.reshape(-1 if isinstance(seed, RungKeys) else ())


def sub_seed(seed, k):
    """The 64-bit key of sub-move ``k`` of a ``BlendedMove`` under
    ``seed``: words 0 and 1 of the main key's counter ``(k, BLEND_BLOCK |
    0xFFFFF, 2**32 - 1, 2**32 - 1)``, an offset no chain reaches.  Every
    counter the sub-move reads under its own key is apart from every
    counter of the main key (K2's accept word, the blend's choice)."""
    w = philox4x32_scalar((k, BLEND_BLOCK | 0xFFFFF, MASK32, MASK32),
                          split_key(seed))
    return w[0] | (w[1] << 32)


def split_seed(seed, split):
    """The 64-bit key under which a red-blue move written outside the port
    draws its proposal of split ``split`` under ``seed``: words 0 and 1
    of the main key's counter ``(2**32 - 1 - split, BLEND_BLOCK | 0xFFFFF,
    2**32 - 1, 2**32 - 1)``, :func:`sub_seed`'s lanes counted down from
    the top, so no sub-move's key is a split's."""
    return sub_seed(seed, MASK32 - split)


def rung_seed(seed, r):
    """The 64-bit key of rung ``r`` of a tempered chain of ``seed``: the
    seed itself for rung 0, else words 0 and 1 of the seed's counter
    ``(r, RUNG_BLOCK | 0xFFFFF, 2**32 - 1, 2**32 - 1)``."""
    if r == 0:
        return int(seed) & 0xFFFFFFFFFFFFFFFF
    w = philox4x32_scalar((r, RUNG_BLOCK | 0xFFFFF, MASK32, MASK32),
                          split_key(seed))
    return w[0] | (w[1] << 32)


class RungKeys(NamedTuple):
    """The keys of a ladder of ``T`` rungs under one chain seed.

    ``seeds`` are the rungs' 64-bit keys (:func:`rung_seed`) as Python
    ints, which the plain versions take one rung at a time; ``table`` is
    the same as a ``(T,)`` int64 tensor (the keys' bits) on the walkers'
    device, which the rung-batched kernels read; ``rounds`` are the ten
    round keys of every rung as ``((T, 1) int64, (T, 1) int64)`` pairs,
    with which :func:`rung_words` draws all rungs in one
    :func:`philox4x32_torch` pass."""

    seeds: tuple
    table: torch.Tensor
    rounds: tuple

    @property
    def seed(self):
        """The chain's seed (rung 0's key)."""
        return self.seeds[0]


def rung_keys(seed, ntemps, device):
    """:class:`RungKeys` of ``ntemps`` rungs under ``seed`` on ``device``
    (made once per chain, outside any recorded graph)."""
    return keys_of(tuple(rung_seed(seed, r) for r in range(ntemps)), device)


def sub_keys(keys, k):
    """:class:`RungKeys` of sub-move ``k`` of a ``BlendedMove`` on every
    rung of ``keys``: rung ``r``'s key is ``sub_seed(keys.seeds[r], k)``,
    so each rung's sub-move draws what it draws on that rung alone (made
    on the host, outside any recorded graph)."""
    return keys_of(tuple(sub_seed(s, k) for s in keys.seeds),
                   keys.table.device)


def keys_of(seeds, device):
    """:class:`RungKeys` of the 64-bit keys ``seeds`` on ``device``."""
    seeds = tuple(int(s) & 0xFFFFFFFFFFFFFFFF for s in seeds)
    table = torch.tensor([s - (1 << 64) if s >= 1 << 63 else s
                          for s in seeds], dtype=torch.int64, device=device)
    per = [_round_keys(split_key(s)) for s in seeds]
    rounds = tuple(
        tuple(torch.tensor([[p[i][w]] for p in per], dtype=torch.int64,
                           device=device) for w in (0, 1))
        for i in range(_ROUNDS))
    return RungKeys(seeds, table, rounds)


def rung_words(keys, n, split, offset, device, roll=False, word=None,
               plain=False):
    """The four Philox words of walker lanes ``0..n-1`` at ``split`` under
    every rung's key: four ``(T, n)`` tensors, rung ``r``'s row equal to
    :func:`walker_words` under ``keys.seeds[r]``, from one pass (only
    word ``word`` where given).  With ``roll``, lane ``ROLL_LANE`` follows
    as column ``n`` (the split's roll draws, :func:`roll_uniforms`).  On
    the CPU the last draw of this thread is kept and served again (as
    :data:`_cpu_draws` serves :func:`walker_words`): K1's, K5a's or
    K5b's and K2's plain versions of one split read the same counters.
    The kept draw's key holds the whole split word, block bits included,
    so K5a's or K5b's ``PAIR_BLOCK`` draw never serves another block."""
    if torch.device(device).type != "cpu":
        out = _draw(plain)("words", n, 1, split, keys, offset,
                           device, word=word, roll=roll)
        return (tuple(w[..., 0] for w in out) if word is None
                else out[..., 0])
    key = (keys.seeds, n, split, _cpu_offset(offset), roll)
    last = getattr(_cpu_draws, "rungs", None)
    if last is None or last[0] != key:
        lo, hi = split_offset(offset)
        lanes = torch.arange(n + bool(roll), dtype=torch.int64)
        if roll:
            lanes[n] = ROLL_LANE
        last = _cpu_draws.rungs = key, philox4x32_torch(
            lanes, split, lo, hi, None, rounds=keys.rounds)
    return last[1] if word is None else last[1][word]


def roll_shift(seed, split, offset, nc, device="cpu"):
    """The roll partner shift of one split, a 0-d int64 tensor:
    ``int(u * nc)`` in float32 arithmetic, as the kernel and
    ``moves/stretch.py:74`` compute it."""
    u = roll_uniforms(seed, split, offset, device)[0]
    return (u * nc).to(torch.int64)


@functools.lru_cache(maxsize=64)
def _round_keys(key):
    """The ten round keys ``((k0, k1), ...)`` of a key, as Python ints
    (computed once per key)."""
    k0, k1 = (int(w) & MASK32 for w in key)
    return tuple(((k0 + _W0 * r) & MASK32, (k1 + _W1 * r) & MASK32)
                 for r in range(_ROUNDS))


def philox4x32_torch(c0, c1, c2, c3, key, rounds=None):
    """The ten rounds in int64 torch arithmetic (any device).  Each
    counter word is an int64 tensor or a Python int holding a value in
    ``[0, 2**32)``; the words broadcast, and every output word is a
    tensor of the broadcast shape once any input word is a tensor.

    The product of a multiplier and a uint32 word is below 2**64, so
    its low 64 bits are all of it.  int64 arithmetic keeps exactly those
    bits and wraps: a product of 2**63 or more comes out negative, its
    bits unchanged.  So the high word is the wrapped product shifted
    right by 32 with the shift's sign bits masked off, and the low word
    its low 32 bits.  (A Python int's product is exact; its high and low
    words are the same.)

    Each torch call costs microseconds on small CPU tensors, and the
    count of calls, not the arithmetic, sets the plain version's time.
    So a round is one wrapped product per lane, the key words and
    multipliers are Python ints (kernel arguments: nothing is copied
    from the host, so the rounds can be recorded into a CUDA graph), and
    the low words ``(c1, c3)`` of tensors are carried as the whole
    wrapped products, masked only where they leave a round's XOR or the
    function (XOR does not carry between bits): ten torch calls a round.

    ``rounds`` replaces ``key`` by the ten round keys as tensors (one key
    per row of a batch: :class:`RungKeys`' ``rounds``); XOR with a
    tensor costs the same one call.
    """
    if rounds is None:
        rounds = _round_keys((int(key[0]), int(key[1])))
    for k0, k1 in rounds:
        p0 = c0 * _M0
        p1 = c2 * _M1
        # c0' = hi(M1 c2) ^ c1 ^ k0, c2' = hi(M0 c0) ^ c3 ^ k1,
        # c1' = lo(M1 c2), c3' = lo(M0 c0).
        c0 = ((p1 >> 32) ^ c1 ^ k0) & MASK32
        c2 = ((p0 >> 32) ^ c3 ^ k1) & MASK32
        # An int's exact product would not fit an int64 tensor's XOR.
        c1 = p1 & MASK32 if isinstance(p1, int) else p1
        c3 = p0 & MASK32 if isinstance(p0, int) else p0
    return c0, c1 & MASK32, c2, c3 & MASK32


def philox4x32(c0, c1, c2, c3, key):
    """Plain Philox4x32-10, elementwise over broadcast counters.

    Each counter word is an int64 tensor (or Python int) holding a value
    in ``[0, 2**32)``; at least one is a tensor.  ``key`` is a pair of
    Python ints.  Returns the four output words as int64 tensors of the
    broadcast shape, on the tensors' device, from
    :func:`philox4x32_torch`, which is held against
    :func:`philox4x32_scalar`.  A Python int stays a kernel argument,
    never a host-to-device copy.
    """
    words = [c.to(torch.int64) if isinstance(c, torch.Tensor)
             else int(c) & MASK32 for c in (c0, c1, c2, c3)]
    return philox4x32_torch(*words, key)


#: The last CPU draw of :func:`walker_words` of this thread, as
#: ``.draw = ((split, seed, offset), n, words)``.  It holds every
#: counter of one split at one offset that a proposal reads: the words
#: of walker lanes ``0..n-1`` at ``split``, of ``ROLL_LANE`` at
#: ``split``, and of lanes ``0..n-1`` at ``PAIR_BLOCK | split``, in that
#: order, from one :func:`philox4x32` call.  The plain versions of one
#: proposal draw the same counters more than once (K1's or K5a's walker
#: words, partner picks and roll draws, then K2's accept word), so on
#: the CPU the later calls read the first one's words.  Words are never
#: written in place, so a shared draw is safe; each thread keeps its
#: own, so samplers on two threads never read each other's.  Nothing is
#: kept for another device: there the draws are recorded into CUDA
#: graphs, and a key would need the device offset word on the host.
_cpu_draws = threading.local()


def _cpu_offset(offset):
    """A proposal offset as a Python int, reading a CPU device word."""
    if isinstance(offset, DeviceOffset):
        return int(offset.word) + offset.inc
    return int(offset)


def _cpu_draw(n, split, seed, offset):
    """``(n, words)`` of this thread's :data:`_cpu_draws` for ``split``
    (without its ``PAIR_BLOCK`` bit) at ``offset``, drawn unless they
    are the last."""
    key = (split & ~PAIR_BLOCK, int(seed) & 0xFFFFFFFFFFFFFFFF,
           _cpu_offset(offset))
    last, last_n, words = getattr(_cpu_draws, "draw", (None, 0, None))
    if last == key and (n is None or last_n == n):
        return last_n, words
    n = n or 0
    lanes = torch.arange(2 * n + 1, dtype=torch.int64)
    lanes[n] = ROLL_LANE
    lanes[n + 1:] -= n + 1
    blocks = torch.full((2 * n + 1,), key[0], dtype=torch.int64)
    blocks[n + 1:] |= PAIR_BLOCK
    lo, hi = split_offset(key[2])
    words = philox4x32(lanes, blocks, lo, hi, split_key(seed))
    _cpu_draws.draw = key, n, words
    return n, words


def walker_words(n, split, seed, offset, device, word=None, plain=False):
    """The four Philox words of walker lanes ``0..n-1`` at ``split`` (only
    word ``word`` where given); ``offset`` is an int or a
    :class:`DeviceOffset`."""
    if torch.device(device).type == "cpu":
        _, words = _cpu_draw(n, split, seed, offset)
        at = slice(n + 1, None) if split & PAIR_BLOCK else slice(0, n)
        out = tuple(w[at] for w in words)
        return out if word is None else out[word]
    out = _draw(plain)("words", n, 1, split, seed, offset, device,
                       word=word)
    return tuple(w[:, 0] for w in out) if word is None else out[:, 0]


def to_uniform(word, dtype=torch.float32):
    """Map a uint32 word (int64 tensor) to a uniform in [0, 1)."""
    return (word >> 8).to(dtype) * 2.0**-24


def box_muller(w0, w2, dtype=torch.float32):
    """A standard normal from two words: ``sqrt(-2 log(1 - u0)) *
    cos(2 pi u2)``, one float32 operation at a time as the kernels
    compute it (``1 - u0`` lies in ``(0, 1]``, so the log is finite)."""
    r = torch.sqrt(-2.0 * torch.log(1.0 - to_uniform(w0, dtype)))
    return r * torch.cos(TWO_PI_F32 * to_uniform(w2, dtype))


def row_words(n, k, block, seed, offset, device, row0=0, word=None,
              plain=False):
    """The words of counters ``(row0 + r, block + j, offset)`` for
    ``r < n``, ``j < k`` (``block | j`` for a block whose low bits are
    clear): four ``(n, k)`` tensors (only word ``word`` where given).
    ``block`` is an int or a 0-d int64 tensor on ``device`` (a block
    indexed by a device counter, such as the slice move's shrink
    iteration)."""
    return _draw(plain)("words", n, k, block, seed, offset, device,
                        row0=row0, word=word)


def word_uniforms(n, k, block, seed, offset, device, word=0,
                  dtype=torch.float32, row0=0, plain=False):
    """``(n, k)`` uniforms of word ``word`` of the counters of
    :func:`row_words`."""
    return _draw(plain)("uniforms", n, k, block, seed, offset,
                        device, row0=row0, word=word, dtype=dtype)


def normals(n, d, seed, offset, device, dtype=torch.float32, row0=0,
            block=NORMAL_BLOCK, plain=False):
    """``(n, d)`` standard normals of rows ``row0 .. row0 + n - 1``:
    normal ``2k`` of a row by Box-Muller on words 0 and 2 of counter
    ``(row, block | k, offset)``, normal ``2k + 1`` on words 1 and 3
    (:func:`box_muller`).  Under a :class:`RungKeys` ``seed``, ``(T, n,
    d)``: rung ``r``'s rows under its own key, every rung from one pass
    (K11's draws on the rung axis)."""
    return _draw(plain)("normals", n, None, block, seed, offset,
                        device, row0=row0, d=d, dtype=dtype)


def row_uniforms(n, d, seed, offset, device, dtype=torch.float32, row0=0,
                 block=PICK_BLOCK, plain=False):
    """``(n, d)`` uniforms of rows ``row0 .. row0 + n - 1``: uniform
    ``4k + w`` of a row from word ``w`` of counter ``(row, block | k,
    offset)``."""
    return _draw(plain)("uniforms", n, None, block, seed, offset,
                        device, row0=row0, d=d, dtype=dtype)

