"""K14: the counter-based Philox draws, as a CUDA kernel and as plain
PyTorch.

Held against the draws the JAX package fuses into their consumers: the
shuffled split's permutation bits (``emcee_tpu/moves/red_blue.py:218``,
vmapped over the rungs by ``parallel/tempering.py:538``) and the normals
and uniforms of the moves of plain torch (``moves/gaussian.py:125-142``,
``kde.py:80``; DIME's, DE-Z's, the slice move's, the side move's and the
walk move's draws are made in K8c, K10b, K9, K5a and K18).  The
port draws its own stream (``ops/philox.py``), so the kernel is held bit
for bit against the plain version, :func:`philox_draw_plain`, which runs
:func:`~.philox.philox4x32_torch` (ten torch calls a round).  The kernel
is ``csrc/philox_draw.cu``, laid out by :func:`draw_plan`: one thread a
counter over every rung's counters in blocks of ``DRAW_THREADS``, a
thread's rung, row and column by a multiply-high with a magic number
(``_wrap.divisor``) instead of a division, and a whole row of uniforms
or normals stored as one vector where the row has no tail.

A draw reads counters ``(row0 + r, block + j, offset)`` for ``r < n``
(and ``ROLL_LANE`` as row ``n`` with ``roll``), ``j < k``, under ``seed``
(an int) or under every rung's key (a :class:`~.philox.RungKeys`: the
output gains a leading rung axis, rung ``t`` drawn under
``keys.seeds[t]``).  ``block`` is an int or a 0-d int64 tensor on the
device (read by the kernel, so a recorded graph reads it at every
replay); ``offset`` an int or a :class:`~.philox.DeviceOffset`.  Kinds
(``rows = n + roll``):

* ``"words"``: the four words as int64 ``(rows, k)`` tensors (a tuple),
  or only ``word``;
* ``"uniforms"``: ``(rows, d)`` uniforms, ``4j + w`` from word ``w``
  (:func:`~.philox.row_uniforms`, ``k = ceil(d / 4)``), or ``(rows, k)``
  uniforms of ``word`` alone;
* ``"normals"``: ``(rows, d)`` Box-Muller normals, ``2j`` from words 0 and
  2, ``2j + 1`` from words 1 and 3 (:func:`~.philox.normals`, ``k =
  ceil(d / 2)``).

Uniforms and normals are float32 or float64.

:func:`philox_draw` launches the kernel for a CUDA device and uses
:func:`philox_draw_plain` for the CPU; it never falls back from one to
the other.  ``philox_draw.launches`` counts kernel launches (and
``philox_draw.device_launches``, when set, on the card:
``_wrap.count_launches``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ._wrap import count_launches, divisor, launch, ptr, rng_args
from .philox import (
    MASK32, ROLL_LANE, RungKeys, box_muller, philox4x32_torch, split_key,
    split_offset, to_uniform)

__all__ = ["DRAW_THREADS", "DRAW_THREADS_LIMIT", "DrawPlan", "KINDS",
           "draw_plan", "philox_draw", "philox_draw_plain"]

#: threads a block of the plan.  On the H100, in graph replays, blocks of
#: 128 were the fastest of 32-1024 at both callers' shapes: workload 4's
#: 16 x 256 keys (a launch that waits on its trips to memory: more, smaller
#: blocks cost their dispatch, fewer, larger ones their warps' issue on one
#: SM) and the DIME stage's 5e4 x 6 normals (PERF.md)
DRAW_THREADS = 128
#: the largest block the kernel takes (kMaxThreads in
#: csrc/philox_draw.cu), for plans forced by a sweep
DRAW_THREADS_LIMIT = 1024
#: kind name -> the kernel's code for it
KINDS = {"words": 0, "uniforms": 1, "normals": 2}
_DTYPES = {torch.float32: 0, torch.float64: 1}
#: counters a word holds for each stored value of a kind
_PER = {"uniforms": 4, "normals": 2}


def _shape(kind, k, d, word):
    """``(k, d)`` of a draw: the counters a row and the stored columns;
    ``d`` fixes ``k`` for every-word uniforms and for normals."""
    if kind == "words" or (kind == "uniforms" and word is not None):
        if d is not None:
            raise ValueError(f"{kind} of one word take k, not d")
        return k, k
    if kind not in _PER:
        raise ValueError(f"unknown kind of draw: {kind!r}")
    if word is not None:
        raise ValueError("normals use every word")
    if d is None or d < 0:
        raise ValueError(f"{kind} need d >= 0")
    return -(-d // _PER[kind]), d


class DrawPlan(NamedTuple):
    """How the kernel is launched: the C entry point's plan arguments."""

    threads: int  #: threads a block, a multiple of 32, a counter each
    blocks: int  #: ``ceil(ntemps * rows * k / threads)``, every rung's
    vec: int  #: 1: every row is whole counters, one vector store each
    rung_mul: int  #: a thread's rung: its index divided by ``rows * k``
    rung_shr: int
    div_mul: int  #: a counter's row: its index in the rung divided by k
    div_shr: int


def draw_plan(kind, rows, k, d, word, ntemps):
    """The launch plan of a draw of ``rows`` rows of ``k`` counters (``d``
    stored columns) on each of ``ntemps`` rungs: one thread a counter over
    every rung's counters, one after the other, in blocks of
    ``DRAW_THREADS``.
    ``vec`` where every row is whole counters of every word: uniforms with
    ``d = 4k``, normals with ``d = 2k``."""
    count = rows * k
    total = ntemps * count
    vec = (word is None and kind in _PER and d == _PER[kind] * k)
    return DrawPlan(DRAW_THREADS, -(-total // DRAW_THREADS), int(vec),
                    *divisor(count), *divisor(k))


def _on(t, device):
    """Whether tensor ``t`` lies on ``device`` (``cuda`` means the current
    card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return t.device == device


def _check(kind, n, k, block, seed, device, row0, word, dtype, roll):
    if kind not in KINDS:
        raise ValueError(f"unknown kind of draw: {kind!r}")
    if word is not None and word not in (0, 1, 2, 3):
        raise ValueError(f"word must be 0-3, got {word}")
    if kind != "words" and dtype not in _DTYPES:
        raise ValueError(f"{kind} are float32 or float64, got {dtype}")
    if n < 0 or k < 0:
        raise ValueError(f"negative rows or counters: n={n}, k={k}")
    if not 0 <= row0 or row0 + n > 1 << 32:
        raise ValueError(f"rows {row0}..{row0 + n} overflow the lane word")
    if isinstance(block, torch.Tensor):
        if (not _on(block, device) or block.dim() != 0
                or block.dtype != torch.int64):
            raise ValueError(f"a block tensor must be a 0-d int64 tensor on "
                             f"{device}, got {block.dtype} {tuple(block.shape)}"
                             f" on {block.device}")
    elif not 0 <= block or block + max(k, 1) > 1 << 32:
        raise ValueError(f"blocks {block}..{block + k - 1} overflow the "
                         "32-bit block word")
    if isinstance(seed, RungKeys):
        t = seed.table
        if not _on(t, device) or t.dtype != torch.int64:
            raise ValueError(f"the rung key table must be int64 on {device}")


def philox_draw_plain(kind, n, k, block, seed, offset, device, *, row0=0,
                      word=None, d=None, dtype=torch.float32, roll=False):
    """Plain PyTorch K14 (any device): the draw of the module docstring,
    from :func:`~.philox.philox4x32_torch`."""
    k, d = _shape(kind, k, d, word)
    _check(kind, n, k, block, seed, device, row0, word, dtype, roll)
    lo, hi = split_offset(offset)
    lanes = torch.arange(row0, row0 + n + bool(roll), dtype=torch.int64,
                         device=device)
    if roll:
        lanes[n] = ROLL_LANE
    cols = block + torch.arange(k, dtype=torch.int64, device=device)
    if isinstance(seed, RungKeys):
        rounds = tuple((a.view(-1, 1, 1), b.view(-1, 1, 1))
                       for a, b in seed.rounds)
        words = philox4x32_torch(lanes[:, None], cols[None, :], lo, hi,
                                 None, rounds=rounds)
    else:
        words = philox4x32_torch(lanes[:, None], cols[None, :], lo, hi,
                                 split_key(seed))
    lead = words[0].shape[:-1]
    if kind == "words":
        return words if word is None else words[word]
    if kind == "uniforms":
        if word is not None:
            return to_uniform(words[word], dtype)
        u = to_uniform(torch.stack(words, dim=-1), dtype)
        return u.reshape(lead + (4 * k,))[..., :d]
    z = torch.stack((box_muller(words[0], words[2], dtype),
                     box_muller(words[1], words[3], dtype)), dim=-1)
    return z.reshape(lead + (2 * k,))[..., :d]


def philox_draw(kind, n, k, block, seed, offset, device, *, row0=0,
                word=None, d=None, dtype=torch.float32, roll=False):
    """K14 on ``device``: the CUDA kernel for a CUDA device, the plain
    version for the CPU.  Arguments as :func:`philox_draw_plain`
    (``k`` is ignored where ``d`` sets it)."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox_draw_plain(kind, n, k, block, seed, offset, device,
                                 row0=row0, word=word, d=d, dtype=dtype,
                                 roll=roll)
    if device.type != "cuda":
        raise ValueError(f"no K14 kernel for device {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    k, d = _shape(kind, k, d, word)
    _check(kind, n, k, block, seed, device, row0, word, dtype, roll)
    rows = n + bool(roll)
    if isinstance(seed, RungKeys):
        ntemps, keys, key = (seed.table.numel(), seed.table,
                             int(seed.seed))
    else:
        ntemps, keys, key = 1, None, int(seed)
    lead = (ntemps,) if keys is not None else ()
    planes = 4 if kind == "words" and word is None else 1
    out = torch.empty(
        (planes,) + lead + (rows, d),
        dtype=torch.int64 if kind == "words" else dtype, device=device)
    if not out.numel():
        return tuple(out.unbind(0)) if planes == 4 else out[0]
    blk = block if isinstance(block, torch.Tensor) else None
    seed64, off_ptr, off = rng_args(key, offset, device)
    plan = draw_plan(kind, rows, k, d, word, ntemps)
    launch("philox_draw", device, out.data_ptr(), KINDS[kind],
           _DTYPES.get(dtype, 0), ntemps, rows, n, k, d,
           -1 if word is None else int(word), int(row0) & MASK32,
           0 if blk is not None else int(block), ptr(blk), seed64,
           ptr(keys), off_ptr, off, plan.threads, plan.vec, plan.rung_mul,
           plan.rung_shr, plan.div_mul, plan.div_shr)
    count_launches(philox_draw)
    return tuple(out.unbind(0)) if planes == 4 else out[0]


philox_draw.launches = 0
philox_draw.device_launches = None
