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
  move sequence is known before it runs.

A uniform is ``(word >> 8) * 2**-24``: 24 random bits, in ``[0, 1)`` and
exact in float32, as ``jax.random.uniform`` draws them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "DeviceOffset",
    "MASK32",
    "ROLL_LANE",
    "MOVE_LANE",
    "MOVE_BLOCK",
    "PAIR_BLOCK",
    "box_muller",
    "philox4x32",
    "philox4x32_scalar",
    "philox4x32_torch",
    "roll_shift",
    "roll_uniforms",
    "split_key",
    "split_offset",
    "to_uniform",
    "uniform_scalar",
    "uniforms_scalar",
    "walker_words",
]

MASK32 = 0xFFFFFFFF
ROLL_LANE = 0xFFFFFFFF
MOVE_LANE = 0xFFFFFFFE
#: split slot of the mixture_block choice on MOVE_LANE
MOVE_BLOCK = 1
#: high bit of the split word: the random-pair partner counter block
PAIR_BLOCK = 0x80000000
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
    for k0, k1 in _round_keys(key):
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


def roll_uniforms(seed, split, offset, device):
    """The four uniforms at counter ``(ROLL_LANE, split, offset)`` as a
    ``(4,)`` float32 tensor on ``device``: the split's roll draws, as the
    kernels compute them."""
    lane = torch.full((), ROLL_LANE, dtype=torch.int64, device=device)
    lo, hi = split_offset(offset)
    return to_uniform(torch.stack(philox4x32(lane, split, lo, hi,
                                             split_key(seed))))


def roll_shift(seed, split, offset, nc, device="cpu"):
    """The roll partner shift of one split, a 0-d int64 tensor:
    ``int(u * nc)`` in float32 arithmetic, as the kernel and
    ``moves/stretch.py:74`` compute it."""
    u = roll_uniforms(seed, split, offset, device)[0]
    return (u * nc).to(torch.int64)


def _mulhilo(m, b):
    """(hi, lo) 32-bit halves of ``m * b`` for int64 tensors holding
    uint32 values.  The full product needs 64 unsigned bits, which
    overflows int64, so ``b`` is split into 16-bit limbs: every partial
    product stays below 2**49."""
    t = m * (b >> 16)
    br = ((t & 0xFFFF) << 16) + m * (b & 0xFFFF)
    return (t >> 16) + (br >> 32), br & MASK32


def _round_keys(key):
    k0, k1 = (int(w) & MASK32 for w in key)
    for r in range(_ROUNDS):
        if r:
            k0 = (k0 + _W0) & MASK32
            k1 = (k1 + _W1) & MASK32
        yield k0, k1


def philox4x32_torch(c0, c1, c2, c3, key):
    """The ten rounds in int64 torch arithmetic (any device), on
    same-shape counter words.

    The multiplied words ``(c0, c2)`` and the passed-on words
    ``(c1, c3)`` are each stacked into one tensor, so a round is one
    limb product and three elementwise operations on both lanes at once:
    each torch call costs microseconds on small CPU tensors, and the
    count of calls, not the arithmetic, sets the plain version's time.
    """
    mul = torch.stack((c0, c2))
    out = torch.stack((c1, c3))
    lead = (2,) + (1,) * (mul.dim() - 1)
    # The constants are made on the device by arithmetic, not copied from
    # the host, so the rounds can be recorded into a CUDA graph.
    lane = torch.arange(2, dtype=torch.int64, device=mul.device)
    m = (_M0 + (_M1 - _M0) * lane).view(lead)
    k0, k1 = (int(w) & MASK32 for w in key)
    r = torch.arange(_ROUNDS, dtype=torch.int64, device=mul.device)
    keys = torch.stack(((k0 + _W0 * r) & MASK32, (k1 + _W1 * r) & MASK32), 1)
    for r in range(_ROUNDS):
        hi, lo = _mulhilo(m, mul)
        # c0' = hi(M1 c2) ^ c1 ^ k0, c2' = hi(M0 c0) ^ c3 ^ k1,
        # c1' = lo(M1 c2), c3' = lo(M0 c0).
        mul, out = hi.flip(0) ^ out ^ keys[r].view(lead), lo.flip(0)
    return mul[0], out[0], mul[1], out[1]


def philox4x32(c0, c1, c2, c3, key):
    """Plain Philox4x32-10, elementwise over broadcast counters.

    Each counter word is an int64 tensor (or Python int) holding a value
    in ``[0, 2**32)``; at least one is a tensor.  ``key`` is a pair of
    Python ints.  Returns the four output words as int64 tensors of the
    broadcast shape, on the tensors' device, from
    :func:`philox4x32_torch`, which is held against
    :func:`philox4x32_scalar`.  A Python int becomes a device fill, never
    a host-to-device copy.
    """
    tensors = [c for c in (c0, c1, c2, c3) if isinstance(c, torch.Tensor)]
    shape = torch.broadcast_shapes(*(t.shape for t in tensors))
    dev = tensors[0].device
    words = [
        c.to(torch.int64).expand(shape) if isinstance(c, torch.Tensor)
        else torch.full(shape, int(c) & MASK32, dtype=torch.int64,
                        device=dev)
        for c in (c0, c1, c2, c3)
    ]
    return philox4x32_torch(*words, key)


def walker_words(n, split, seed, offset, device):
    """The four Philox words of walker lanes ``0..n-1`` at ``split``;
    ``offset`` is an int or a :class:`DeviceOffset`."""
    lo, hi = split_offset(offset)
    lanes = torch.arange(n, dtype=torch.int64, device=device)
    return philox4x32(lanes, split, lo, hi, split_key(seed))


def to_uniform(word, dtype=torch.float32):
    """Map a uint32 word (int64 tensor) to a uniform in [0, 1)."""
    return (word >> 8).to(dtype) * 2.0**-24


def box_muller(w0, w2, dtype=torch.float32):
    """A standard normal from two words: ``sqrt(-2 log(1 - u0)) *
    cos(2 pi u2)``, one float32 operation at a time as the kernels
    compute it (``1 - u0`` lies in ``(0, 1]``, so the log is finite)."""
    r = torch.sqrt(-2.0 * torch.log(1.0 - to_uniform(w0, dtype)))
    return r * torch.cos(TWO_PI_F32 * to_uniform(w2, dtype))
