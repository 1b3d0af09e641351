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
  proposal on the host);
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
* counter ``(ROLL_LANE, split, ...)``: the split's roll draws, computed
  on the host: word 0 the stretch shift; words 0 and 1 DE's two shifts;
  words 0-3 the snooker's role permutation and three shifts;
* counter ``(MOVE_LANE, 0, ...)``, word 0: the weighted-move choice of a
  proposal; ``(MOVE_LANE, 1, ...)``, word 0: the choice of a
  ``mixture_block`` block, at the offset of the block's first proposal.

A uniform is ``(word >> 8) * 2**-24``: 24 random bits, in ``[0, 1)`` and
exact in float32, as ``jax.random.uniform`` draws them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
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


def split_key(seed: int):
    """The two 32-bit key words of a 64-bit seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & MASK32, seed >> 32


def split_offset(offset: int):
    """The two 32-bit counter words of a 64-bit proposal offset."""
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


def roll_shift(seed, split, offset, nc):
    """The roll partner shift of one split: ``int(u * nc)`` in float32
    arithmetic, as the kernel and ``moves/stretch.py:74`` compute it."""
    u = np.float32(uniform_scalar(seed, ROLL_LANE, split, offset))
    return int(u * np.float32(nc))


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
    m = torch.tensor((_M0, _M1), dtype=torch.int64, device=mul.device)
    keys = torch.tensor(list(_round_keys(key)), dtype=torch.int64,
                        device=mul.device)
    m = m.view(lead)
    for r in range(_ROUNDS):
        hi, lo = _mulhilo(m, mul)
        # c0' = hi(M1 c2) ^ c1 ^ k0, c2' = hi(M0 c0) ^ c3 ^ k1,
        # c1' = lo(M1 c2), c3' = lo(M0 c0).
        mul, out = hi.flip(0) ^ out ^ keys[r].view(lead), lo.flip(0)
    return mul[0], out[0], mul[1], out[1]


def philox4x32(c0, c1, c2, c3, key):
    """Plain Philox4x32-10, elementwise over broadcast counters.

    Each counter word is an int64 tensor (or Python int) holding a value
    in ``[0, 2**32)``; ``key`` is a pair of Python ints.  Returns the four
    output words as int64 tensors of the broadcast shape, on the
    tensors' device, from :func:`philox4x32_torch`, which is held
    against :func:`philox4x32_scalar`.
    """
    ref = next(c for c in (c0, c1, c2, c3) if isinstance(c, torch.Tensor))
    words = torch.broadcast_tensors(
        *(
            torch.as_tensor(c, dtype=torch.int64, device=ref.device)
            for c in (c0, c1, c2, c3)
        )
    )
    return philox4x32_torch(*words, key)


def walker_words(n, split, seed, offset, device):
    """The four Philox words of walker lanes ``0..n-1`` at ``split``."""
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
