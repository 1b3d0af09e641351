"""K16 and K17: the shuffled split's group order and its row gathers and
scatters, as CUDA kernels and as plain PyTorch.

Held against ``emcee_tpu/moves/red_blue.py:211-276`` (``_propose_shuffled``:
the permutation and strided grouping at ``:218-219``, each group's row
gathers and ``.at[idx].set`` write-backs), which XLA fuses into one
program and ``emcee_tpu/parallel/tempering.py:538`` vmaps over the rungs.

* **K16, the group order** (:func:`group_order`, ``csrc/shuffle_order.cu``):
  from the sort keys of each segment (one ensemble, or every rung of a
  ladder: Philox word 3 of the walker lanes, ``ops/philox.py``
  ``walker_words`` / ``rung_words``), the flat rows in group order: row
  ``j * ng + i`` of segment ``r`` is ``r * n + perm_r[i * nsplits + j]``,
  ``perm_r`` the stable argsort of the segment's keys.  A segment of at
  most ``RANK_MAX`` walkers is ranked in shared memory (each thread counts
  the keys below its own; one launch), a longer one sorted by a stable
  LSD radix sort of the 32-bit keys, four 8-bit digits: a histogram
  launch, then a launch a digit whose tiles find their place by a
  decoupled look-back (:func:`shuffle_plan`; ``RADIX_PASSES + 1``
  launches).  :func:`sorted_words` runs it with one split and writes the
  sort words ``(key << 32) | index`` in sorted order (the order
  optional), as R-hat's ranks read them (``ops/autocorr_kernel.py``).
* **K17, the rows** (:func:`gather_rows`, :func:`scatter_rows`,
  ``csrc/gather_rows.cu``): every buffer's rows through the order in one
  launch, each buffer a descriptor (bases, row bytes, copy unit) as K2's
  blob leaves are (``ops/accept_kernel.py`` ``blob_unit``): ``gather``
  writes ``out[k] = src[order[k]]``, ``scatter`` ``dst[order[k]] =
  src[k]``, for buffers of any dtype and row shape.

The plain versions are the route the port took before the kernels, moved
here unchanged: ``torch.argsort(stable=True)``, the transpose and the
base add (:func:`group_order_plain`; ``torch.sort(stable=True)`` for
:func:`sorted_words_plain`); ``index_select`` and ``index_copy_``
a buffer (:func:`gather_rows_plain`, :func:`scatter_rows_plain`).  On the
card the kernels equal them bit for bit and byte for byte.

Each wrapper runs its plain version for CPU tensors and launches its
kernel for CUDA tensors; it never falls back from one to the other, and
counts its launches in ``<wrapper>.launches`` (and
``<wrapper>.device_launches``, when set, on the card:
``_wrap.count_launches``).  Nothing is built when this module is
imported.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._wrap import count_launches, device_sm_count, divisor, launch, ptr
from .accept_kernel import blob_unit

__all__ = ["RADIX_TILES", "ROWS_CAPACITY", "ShufflePlan",
           "gather_rows", "gather_rows_plain", "group_order",
           "group_order_plain", "radix_scratch", "rows_plan",
           "scatter_rows", "scatter_rows_plain", "shuffle_plan",
           "sorted_words", "sorted_words_plain"]

#: the longest segment the rank route takes (kRankMax in
#: csrc/shuffle_order.cu): 16 KB of words that every block of the segment
#: loads
RANK_MAX = 2048
#: the rank route's block, a thread a walker (kRankThreads)
RANK_THREADS = 64
#: the radix route's block (kRadixThreads): a thread a digit in the
#: look-back
RADIX_THREADS = 256
#: the radix route's digit passes (kPasses) and bins a digit (kBins)
RADIX_PASSES = 4
RADIX_BINS = 256
#: the statuses a look-back step reads at once (kLookBack)
RADIX_LOOKBACK = 16
#: the radix route's tiles, keys a block of a pass (256 threads x 1, 4
#: or 16 keys: the kernel's instantiations), the plan's largest first
RADIX_TILES = (4096, 1024, 256)
#: keys a histogram block takes at least (the blocks of every segment
#: stay within one a streaming multiprocessor)
HIST_KEYS = 4096
#: shared memory a block takes without opting in
SMEM_LIMIT = 48 * 1024
#: buffers one launch of K17 takes (kMaxBufs in csrc/gather_rows.cu)
ROWS_CAPACITY = 32
#: K17's threads a block, one unit each (kThreads)
ROWS_THREADS = 256


class ShufflePlan(NamedTuple):
    """How K16 sorts ``T`` segments of ``n`` walkers."""

    route: str  #: "rank" or "radix"
    chunk: int  #: keys a block of a radix pass sorts, its tile (0: rank)
    threads: int  #: a block's threads
    chunks: int  #: blocks a segment of a launch (the radix route's tiles)
    hist: int  #: histogram blocks a segment (the radix route; else 0)
    smem: int  #: a block's shared memory, bytes

    @property
    def launches(self):
        """Kernel launches of one call: the radix route's histogram and
        digit passes, else one."""
        return 1 + RADIX_PASSES if self.route == "radix" else 1


def radix_smem(tile):
    """A radix pass's static shared memory at ``tile`` keys a block: the
    tile's words, the warps' digit counts, two block scans' words, the
    digits' local starts and destinations."""
    warps = RADIX_THREADS // 32
    return 8 * tile + 4 * warps * RADIX_BINS + 4 * 2 * warps + (
        4 + 4) * RADIX_BINS


def radix_scratch(plan, T, n):
    """int64 words of the radix route's scratch (``emcee_group_order``'s
    layout): the passes' two buffers of ``T n`` words, then 32-bit words:
    two status buffers of every tile's digits and the histogram blocks'
    counts (0 on the rank route)."""
    if plan.route != "radix":
        return 0
    u32 = (2 * T * plan.chunks * RADIX_BINS
           + T * plan.hist * RADIX_PASSES * RADIX_BINS)
    return 2 * T * n + -(-u32 // 2)


def shuffle_plan(T, n, ns, n_sm, tile=None):
    """K16's route and launch shape for ``T`` segments of ``n`` walkers
    split ``ns`` ways, on a card of ``n_sm`` SMs.

    Rank route, ``n <= RANK_MAX``: blocks of ``RANK_THREADS``, a thread a
    walker, each block loading its segment's words (16 KB at most, static
    shared memory) and ranking its own; one launch.  Radix route above:
    ``RADIX_THREADS`` a block, the largest of ``RADIX_TILES`` whose tiles
    of every segment fill half the card (``2 T tiles >= n_sm``; else the
    smallest, 256 keys), and a histogram launch of at least ``HIST_KEYS``
    keys a block, at most ``n_sm`` blocks in all; ``1 +
    RADIX_PASSES`` launches.  (On an H100 that rule took the fastest of
    these tiles at one segment of 4096 to 6e7 keys and at 16 x 1e4 and 64
    x 4098, but for one of 5e4: ``chip_smoke.py k16-tiles``.)  ``tile``
    forces the radix route with that tile (one of ``RADIX_TILES``), at any
    ``n``."""
    if T < 1 or n < 1 or ns < 1 or n % ns:
        raise ValueError(f"bad segments: {T} x {n} walkers in {ns} splits")
    if tile is None and n <= RANK_MAX:
        return ShufflePlan("rank", 0, RANK_THREADS, -(-n // RANK_THREADS), 0,
                           8 * RANK_MAX)
    if tile is None:
        tile = next((t for t in RADIX_TILES if 2 * T * -(-n // t) >= n_sm),
                    RADIX_TILES[-1])
    elif tile not in RADIX_TILES:
        raise ValueError(f"tile must be one of {RADIX_TILES}, got {tile}")
    hist = max(1, min(-(-n // HIST_KEYS), -(-n_sm // T)))
    return ShufflePlan("radix", tile, RADIX_THREADS, -(-n // tile), hist,
                       radix_smem(tile))


def _segments(words):
    """``(T, n)`` of a ``(n,)`` or ``(T, n)`` key tensor."""
    if words.dim() == 1:
        return 1, words.shape[0]
    if words.dim() == 2:
        return tuple(words.shape)
    raise ValueError("the sort keys must be (n,) or (T, n)")


def group_order_plain(words, nsplits, out=None):
    """Plain K16: the flat rows of ``words``' segments in group order,
    ``(T * n,)`` int64 (``(n,)`` for one ensemble's ``(n,)`` keys)."""
    T, n = _segments(words)
    perm = torch.argsort(words.view(T, n), dim=-1, stable=True)
    order = perm.view(T, n // nsplits, nsplits).transpose(1, 2)
    if T > 1:
        base = torch.arange(0, T * n, n, device=words.device)
        order = order.reshape(T, n) + base[:, None]
    order = order.reshape(-1)
    return order if out is None else out.copy_(order)


def group_order(words, nsplits, out=None):
    """K16 on ``words``' device: each segment's (row of ``words``) stable
    order of its keys (int64 words below ``2**32``), as the flat rows of
    every segment in group order: ``(T * n,)`` int64, written into ``out``
    where given.  The CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if words.device.type == "cpu":
        return group_order_plain(words, nsplits, out)
    if words.device.type != "cuda":
        raise ValueError(f"no K16 kernel for device {words.device}")
    T, n = _segments(words)
    dev = words.device
    if words.dtype != torch.int64 or not words.is_contiguous():
        raise ValueError("the sort keys must be a contiguous int64 tensor")
    if T > 65535 or T * n >= 2**31 or n >= 2**29:
        raise ValueError(f"too many walkers for K16: {T} x {n}")
    if out is None:
        out = torch.empty(T * n, dtype=torch.int64, device=dev)
    elif (out.device != dev or out.dtype != torch.int64
          or tuple(out.shape) != (T * n,) or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({T * n},) int64 tensor "
                         f"on {dev}")
    plan = shuffle_plan(T, n, nsplits, device_sm_count(dev))
    _launch_order(plan, words, nsplits, out)
    return out


def sorted_words_plain(keys, words, order=None):
    """Plain K16 with one split: ``torch.sort(stable=True)`` of each row of
    ``keys``, as the words ``(key << 32) | index`` into ``words`` and the
    flat rows into ``order`` where given."""
    T, n = _segments(keys)
    vals, idx = torch.sort(keys.view(T, n), dim=-1, stable=True)
    words.view(T, n).copy_((vals << 32) | idx)
    if order is not None:
        base = torch.arange(0, T * n, n, device=keys.device)
        order.copy_((idx + base[:, None]).reshape(-1))


def sorted_words(keys, words, order=None):
    """K16 with one split on ``keys``' device: each segment's (row of
    ``keys``) stable sort of its keys (int64 words below ``2**32``), as
    the words ``(key << 32) | index in the segment`` in sorted order into
    ``words`` (``keys``' shape, int64) and, where ``order`` ``(T * n,)``
    is given, the flat rows as :func:`group_order` writes them.  The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if keys.device.type == "cpu":
        return sorted_words_plain(keys, words, order)
    if keys.device.type != "cuda":
        raise ValueError(f"no K16 kernel for device {keys.device}")
    T, n = _segments(keys)
    dev = keys.device
    for name, t, shape in (("the sort keys", keys, tuple(keys.shape)),
                           ("words", words, tuple(keys.shape)),
                           ("order", order, (T * n,))):
        if t is not None and (t.device != dev or t.dtype != torch.int64
                              or tuple(t.shape) != shape
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {shape} int64 "
                             f"tensor on {dev}")
    if T > 65535 or T * n >= 2**31 or n >= 2**29:
        raise ValueError(f"too many keys for K16: {T} x {n}")
    plan = shuffle_plan(T, n, 1, device_sm_count(dev))
    _launch_order(plan, keys, 1, order, words)


def _launch_order(plan, words, nsplits, out, sorted_out=None):
    """Launch K16 with plan ``plan`` on checked arguments (the order into
    ``out``, the sorted words into ``sorted_out``, either None); the radix
    route's scratch (:func:`radix_scratch`) comes from ``torch.empty`` (a
    graph records it in its pool; the kernels zero what must start at
    zero)."""
    T, n = _segments(words)
    scratch = None
    if plan.route == "radix":
        scratch = torch.empty(radix_scratch(plan, T, n), dtype=torch.int64,
                              device=words.device)
    launch("group_order", words.device, words.data_ptr(), ptr(out),
           ptr(sorted_out), ptr(scratch), T, n, nsplits, plan.chunk,
           plan.threads, plan.hist)
    count_launches(group_order, plan.launches)


class _RowBuf(ctypes.Structure):
    """One buffer as the C entry point takes it (``RowBuf`` in
    ``csrc/gather_rows.cu``)."""

    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("row_bytes", ctypes.c_int), ("unit", ctypes.c_int),
                ("upr_mul", ctypes.c_uint32), ("upr_shr", ctypes.c_int),
                ("first_block", ctypes.c_int), ("units", ctypes.c_int)]


def rows_plan(rows, bufs):
    """K17's descriptors and blocks for ``rows`` rows of buffers ``bufs``
    ``(src pointer, dst pointer, row bytes)``: ``(descriptors, blocks)``,
    the descriptors ``(src, dst, row bytes, unit, upr_mul, upr_shr,
    first block, units)`` in the buffers' order, cut into launches of
    ``ROWS_CAPACITY``; ``blocks[g]`` the blocks of launch ``g``, each
    buffer's first block counted within its launch.  A buffer's units are
    ``rows * row_bytes / unit``, one a thread, in blocks of
    ``ROWS_THREADS``."""
    descs, blocks = [], []
    for i, (src, dst, row) in enumerate(bufs):
        if i % ROWS_CAPACITY == 0:
            blocks.append(0)
        unit = blob_unit(src, dst, row)
        units = rows * (row // unit)
        if units >= 2**31:
            raise ValueError(f"a buffer of {rows} rows of {row} bytes is too "
                             "large for K17's 32-bit unit index")
        mul, shr = divisor(row // unit)
        descs.append((src, dst, row, unit, mul, shr, blocks[-1], units))
        blocks[-1] += -(-units // ROWS_THREADS)
    return descs, blocks


def _check_order(order, dev):
    if (order.device != dev or order.dtype != torch.int64
            or order.dim() != 1 or not order.is_contiguous()):
        raise ValueError(f"order must be a contiguous (rows,) int64 tensor "
                         f"on {dev}")
    return order.shape[0]


def _check_pair(name, a, b, rows, dev):
    if a.device != dev or b.device != dev:
        raise ValueError(f"{name}: every buffer must lie on {dev}")
    if a.dtype != b.dtype or a.shape != b.shape:
        raise ValueError(f"{name}: a buffer and its rows differ: "
                         f"{a.dtype} {tuple(a.shape)} against {b.dtype} "
                         f"{tuple(b.shape)}")
    if a.dim() < 1 or a.shape[0] != rows:
        raise ValueError(f"{name}: buffers must hold the order's {rows} rows "
                         f"on their first axis, got {tuple(a.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: buffers must be contiguous")


def _launch_rows(order, pairs, scatter, fn):
    """Launch K17 over ``pairs`` ``(src, dst)`` (their rows checked);
    buffers whose rows hold no byte are skipped."""
    rows = order.shape[0]
    bufs = [(s.data_ptr(), d.data_ptr(), s[0].numel() * s.element_size())
            for s, d in pairs if rows and s[0].numel()]
    if not bufs:
        return
    descs, blocks = rows_plan(rows, bufs)
    table = (_RowBuf * len(descs))(*[_RowBuf(*d) for d in descs])
    nblk = (ctypes.c_int * len(blocks))(*blocks)
    launch("copy_rows", order.device, order.data_ptr(),
           ctypes.addressof(table), len(descs), ctypes.addressof(nblk),
           int(scatter))
    count_launches(fn, len(blocks))


def gather_rows_plain(order, srcs, outs=None):
    """Plain K17 gather: ``src.index_select(0, order)`` of each buffer
    (copied into ``outs`` where given); returns the gathered buffers."""
    if outs is None:
        return [s.index_select(0, order) for s in srcs]
    for s, o in zip(srcs, outs, strict=True):
        o.copy_(s.index_select(0, order))
    return list(outs)


def gather_rows(order, srcs, outs=None):
    """K17's gather on the buffers' device: row ``k`` of each ``outs[i]``
    (new buffers if None) is row ``order[k]`` of ``srcs[i]``, every buffer
    in one launch.  Each buffer holds ``len(order)`` rows on its first
    axis, any dtype and row shape.  Returns the gathered buffers."""
    if order.device.type == "cpu":
        return gather_rows_plain(order, srcs, outs)
    if order.device.type != "cuda":
        raise ValueError(f"no K17 kernel for device {order.device}")
    rows = _check_order(order, order.device)
    if outs is None:
        outs = [torch.empty_like(s, memory_format=torch.contiguous_format)
                for s in srcs]
    pairs = list(zip(srcs, outs, strict=True))
    for s, o in pairs:
        _check_pair("gather_rows", s, o, rows, order.device)
    _launch_rows(order, pairs, False, gather_rows)
    return list(outs)


def scatter_rows_plain(order, dsts, srcs):
    """Plain K17 scatter: ``dst.index_copy_(0, order, src)`` of each
    buffer."""
    for d, s in zip(dsts, srcs, strict=True):
        d.index_copy_(0, order, s)


def scatter_rows(order, dsts, srcs):
    """K17's scatter on the buffers' device: row ``order[k]`` of each
    ``dsts[i]`` becomes row ``k`` of ``srcs[i]``, every buffer in one
    launch (``order`` a permutation of the rows)."""
    if order.device.type == "cpu":
        return scatter_rows_plain(order, dsts, srcs)
    if order.device.type != "cuda":
        raise ValueError(f"no K17 kernel for device {order.device}")
    rows = _check_order(order, order.device)
    pairs = list(zip(srcs, dsts, strict=True))
    for s, d in pairs:
        _check_pair("scatter_rows", s, d, rows, order.device)
    _launch_rows(order, pairs, True, scatter_rows)


group_order.launches = 0
group_order.device_launches = None
gather_rows.launches = 0
gather_rows.device_launches = None
scatter_rows.launches = 0
scatter_rows.device_launches = None
