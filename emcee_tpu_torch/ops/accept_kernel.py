"""K2: the accept/select write-back, as a CUDA kernel and as plain PyTorch.

Held against ``emcee_tpu/moves/red_blue.py:196-204`` (``_inner``: the
Metropolis compare and select) and ``:323-344`` (the write-back of the
selected rows into the ensemble).  The kernel is
``csrc/accept_select.cu``.  It is bound by bytes and latency (no matrix
product, no tensor-core work): about 2 MB per launch at the main path's
shape and 1.4 MB at workload 3's, a few microseconds at most.  A block
owns a tile of consecutive walkers (``_wrap.tile_plan``): one thread per
walker decides, then the block writes the accepted rows of the tile as
one flat, masked float4 stream.

Of the kernel's two variants the wrapper takes the staged one wherever
it can: each tile's q span comes into shared memory by one TMA bulk
copy issued at block start, overlapping the accept decision's loads.
On the H100 it was faster than reading q from device memory after the
decision at both the main path's shape (ndim 5) and workload 3's (ndim
100), though it reads the rejected rows too (``chip_smoke.py`` phase 6;
the times are in ``PERF.md``).  The direct variant serves where staging
cannot: a q that is not 16-byte aligned, or rows too wide for even 4 of
them to fit in shared memory.

The JAX package returns new arrays; here the selected rows are written
in place into block ``split`` of the ensemble buffers ``coords``
``(nwalkers, ndim)`` and ``log_prob`` ``(nwalkers,)``, which saves a copy
of the ensemble per split.  ``accepted`` ``(nwalkers,)`` bool receives
the block's acceptance, and the optional int32 ``count`` ``(nwalkers,)``
adds it, so acceptance accumulates on the device.

With ``nsplits=1`` the split is the whole ensemble (``MHMove`` and
``GaussianMove``, which need no complement): ``ng = nwalkers``, and the
tile plan and the kernel's indexing are the same at any ``ng``.

``blobs`` is an optional sequence of blob leaf pairs ``(new (ng,
*shape), buf (nwalkers, *shape))`` of any dtype: the accepted walkers'
rows of ``new`` are written into block ``split`` of ``buf``, with the
same mask as the coordinates (``red_blue.py:200-202``, ``tree_where``).
The kernel does it in the same launch, as a masked byte stream per leaf
(see the source).  :func:`leaf_plan` chooses how: up to ``ROW_LEAVES``
leaves whose rows are each one 4- or 8-byte unit (scalar blobs, the main
path's) are read into registers by each walker's thread before the
decision; any other leaves are read after the decision.  The leaves beyond
``BLOB_CAPACITY`` go to further launches of a blob-only kernel that reads
the split's ``accepted``.  The plain version is
``torch.where`` per leaf; the two agree bit for bit (bytes are copied,
never converted).

The rung axis (parallel tempering): the ensemble buffers may be ``(T,
nwalkers, ...)``, ``T`` ensembles of one ladder, with ``q`` ``(T, ng,
ndim)``, ``factor``, ``lp_q`` and ``log_u`` ``(T, ng)`` and each blob
leaf's new rows ``(T, ng, ...)`` and buffer ``(T, nwalkers, ...)``,
through either leaf path (:func:`leaf_plan`; 8-byte scalar leaves take
phase C there).
Rung ``r``'s split group is its rows ``split*ng .. +ng``, and it draws
its accept uniform under its own key (``seed`` is then a
:class:`~.philox.RungKeys`).  One launch serves every rung; the plain
version draws every rung's words in one pass and selects elementwise
over the rungs, so each rung equals the same rung selected alone.

The accept uniform is Philox word 1 at ``(walker, split, offset)``
(``offset`` an int or a ``DeviceOffset``), or the injected ``log_u``
(ng,) (the parity mode: ``RedBlueMove._inner``'s ``log_u`` argument in
the JAX package).

:func:`accept_select` launches the kernel for CUDA tensors and uses
:func:`accept_select_plain` for CPU tensors; it never falls back from one
to the other.  ``accept_select.launches`` counts kernel launches
(and ``accept_select.device_launches``, when set, on the card:
``_wrap.count_launches``).
"""

from __future__ import annotations

import ctypes

import torch

from ._wrap import (
    check_f32, check_rows, count_launches, device_sm_count, key_args, launch,
    ptr, rng_args, tile_plan)
from .philox import RungKeys, rung_keys, rung_words, to_uniform, walker_words

__all__ = ["BLOB_CAPACITY", "ROW_LEAVES", "accept_select",
           "accept_select_plain", "blob_leaves", "blob_unit", "leaf_plan"]

#: blob leaves one launch of the kernel selects (kMaxLeaves in
#: csrc/accept_select.cu); further leaves take blob-only launches
BLOB_CAPACITY = 16
#: leaves whose rows are each one 4- or 8-byte unit that a launch reads
#: into registers (kRowLeaves in csrc/accept_select.cu)
ROW_LEAVES = 4
#: the units of such rows
ROW_UNITS = (4, 8)


class _BlobLeaf(ctypes.Structure):
    """One blob leaf as the C entry point takes it (``BlobLeaf`` in
    ``csrc/accept_select.cu``)."""

    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("row_bytes", ctypes.c_int), ("unit", ctypes.c_int),
                ("inv_upr", ctypes.c_uint32)]


#: the shift of a leaf's ``inv_upr`` (``BlobLeaf`` in
#: ``csrc/accept_select.cu``): ``(k * inv_upr) >> UPR_SHIFT == k // upr``
#: for every unit index ``0 <= k <= TILE_MAX`` of a thread's first step
UPR_SHIFT = 24


def inv_upr(row_bytes, unit):
    """``ceil(2**UPR_SHIFT / upr)`` for ``upr = row_bytes // unit`` units a
    row: the kernel's division of a thread's first unit index (below
    ``TILE_MAX``) and of ``TILE_MAX`` by ``upr``, exact because their
    product with the rounding error stays below ``2**UPR_SHIFT /
    upr``."""
    return -(-(1 << UPR_SHIFT) // (row_bytes // unit))


def blob_unit(src_ptr, dst_ptr, row_bytes):
    """The kernel's access unit for a leaf: the largest of 16, 8, 4, 2
    and 1 bytes that divides both byte addresses and the row, so that no
    unit holds bytes of two walkers."""
    for unit in (16, 8, 4, 2):
        if not (src_ptr % unit or dst_ptr % unit or row_bytes % unit):
            return unit
    return 1


def leaf_plan(leaves, rungs=False):
    """How K2 selects blob leaves ``(src, dst, row bytes)``: ``([(src,
    dst, row bytes, unit, inv_upr), ...], row_unit)``, the kernel's
    descriptor of each leaf and the row unit.  Where every leaf's row is
    one unit of 4 or 8 bytes (scalar blobs) and there are at most
    ``ROW_LEAVES`` of them, the row unit is that unit: each walker's
    thread reads its row of every leaf into registers before the
    decision.  Otherwise it is 0, and the leaves are read after the
    decision (phase C).  On the rung axis (``rungs``) the register path
    is built for 4-byte units only (the tempered ``logL`` and ``logP``
    and up to two user scalars beside them); 8-byte scalar leaves take
    phase C there."""
    units = [blob_unit(src, dst, row) for src, dst, row in leaves]
    row_unit = 0
    if (0 < len(leaves) <= ROW_LEAVES
            and units[0] in ((4,) if rungs else ROW_UNITS)
            and all(u == units[0] == row
                    for u, (_, _, row) in zip(units, leaves))):
        row_unit = units[0]
    return ([(src, dst, row, unit, inv_upr(row, unit))
             for (src, dst, row), unit in zip(leaves, units)], row_unit)


def blob_leaves(blobs, ng, nw, device, lead=()):
    """The kernel's view of checked blob leaf pairs: ``(new pointer,
    buffer pointer, row bytes)`` of each leaf whose row has a byte or
    more.  ``lead`` is ``(T,)`` on the rung axis: the new rows are then
    ``(T, ng, ...)`` and the buffer ``(T, nw, ...)``."""
    leaves = []
    k = len(lead)
    for new, buf in blobs:
        if new.device != device or buf.device != device:
            raise ValueError(f"blob leaves must lie on {device}")
        if new.dtype != buf.dtype:
            raise ValueError(f"a blob leaf's new rows are {new.dtype}, its "
                             f"buffer {buf.dtype}")
        if (new.dim() <= k or buf.dim() <= k
                or tuple(new.shape[:k + 1]) != lead + (ng,)
                or tuple(buf.shape[:k + 1]) != lead + (nw,)
                or new.shape[k + 1:] != buf.shape[k + 1:]):
            raise ValueError(
                f"a blob leaf must be {lead + (ng,)} + row new rows and a "
                f"{lead + (nw,)} + row buffer of one row shape, got "
                f"{tuple(new.shape)} and {tuple(buf.shape)}")
        if not (new.is_contiguous() and buf.is_contiguous()):
            raise ValueError("blob leaves must be contiguous")
        row = buf[(0,) * (k + 1)].numel() * buf.element_size()
        if row:
            leaves.append((new.data_ptr(), buf.data_ptr(), row))
    return leaves


def accept_select_plain(q, factor, lp_q, coords, log_prob, split, nsplits,
                        accepted, count=None, *, seed=0, offset=0,
                        log_u=None, blobs=()):
    """Plain PyTorch K2; updates the buffers (and every blob leaf's
    buffer) in place and returns the block's acceptance ``(ng,)`` bool (a
    view of ``accepted``; ``(T, ng)`` on the rung axis, rung by rung)."""
    rungs = coords.dim() == 3  # (T, nwalkers, ndim): the rung axis
    ng = coords.shape[-2] // nsplits
    lo = split * ng
    dev = coords.device
    if log_u is None and rungs:
        keys = seed if isinstance(seed, RungKeys) else rung_keys(
            seed, coords.shape[0], dev)
        w1 = rung_words(keys, ng, split, offset, dev, roll=True)[1][:, :ng]
        log_u = torch.log(to_uniform(w1, factor.dtype))
    elif log_u is None:
        _, w1, _, _ = walker_words(ng, split, seed, offset, dev)
        log_u = torch.log(to_uniform(w1, factor.dtype))
    s = coords[..., lo:lo + ng, :]
    lp_s = log_prob[..., lo:lo + ng]
    lnpdiff = factor + lp_q - lp_s
    acc = log_u < lnpdiff
    s.copy_(torch.where(acc[..., None], q, s))
    lp_s.copy_(torch.where(acc, lp_q, lp_s))
    k = acc.dim()
    for new, buf in blobs:
        b = buf[(slice(None),) * (k - 1) + (slice(lo, lo + ng),)]
        b.copy_(torch.where(acc.view(acc.shape + (1,) * (b.dim() - k)), new,
                            b))
    accepted[..., lo:lo + ng] = acc
    if count is not None:
        count[..., lo:lo + ng] += acc
    return accepted[..., lo:lo + ng]


def accept_select(q, factor, lp_q, coords, log_prob, split, nsplits,
                  accepted, count=None, *, seed=0, offset=0, log_u=None,
                  blobs=()):
    """K2 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    args = (q, factor, lp_q, coords, log_prob, split, nsplits, accepted,
            count)
    kw = dict(seed=seed, offset=offset, log_u=log_u, blobs=blobs)
    if coords.device.type == "cpu":
        return accept_select_plain(*args, **kw)
    if coords.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {coords.device}")
    nw, nd, ng = check_rows(coords, split, nsplits, min_splits=1,
                            rungs=True)
    dev = coords.device
    lead = tuple(coords.shape[:-2])  # (T,) on the rung axis, else ()
    check_f32("log_prob", log_prob, dev, lead + (nw,))
    check_f32("q", q, dev, lead + (ng, nd))
    check_f32("factor", factor, dev, lead + (ng,))
    check_f32("lp_q", lp_q, dev, lead + (ng,))
    check_f32("log_u", log_u, dev, lead + (ng,))
    if (accepted.device != dev or accepted.dtype != torch.bool
            or tuple(accepted.shape) != lead + (nw,)
            or not accepted.is_contiguous()):
        raise ValueError(f"accepted must be a contiguous {lead + (nw,)} "
                         f"bool tensor on {dev}")
    if count is not None and (
            count.device != dev or count.dtype != torch.int32
            or tuple(count.shape) != lead + (nw,)
            or not count.is_contiguous()):
        raise ValueError(f"count must be a contiguous {lead + (nw,)} int32 "
                         f"tensor on {dev}")
    rung_launch = bool(lead and lead[0] > 1) or isinstance(seed, RungKeys)
    leaves, row_unit = leaf_plan(blob_leaves(blobs, ng, nw, dev, lead),
                                 rungs=rung_launch)
    plan = tile_plan(ng, nd, split, device_sm_count(dev), coords.data_ptr(),
                     q.data_ptr(), stage=True, rungs=lead[0] if lead else 1,
                     nsplits=nsplits)
    _launch(plan, q, factor, lp_q, coords, log_prob, split, accepted, count,
            seed, offset, log_u, leaves, row_unit)
    count_launches(accept_select, max(1, -(-len(leaves) // BLOB_CAPACITY)))
    return accepted[..., split * ng:(split + 1) * ng]


def _launch(plan, q, factor, lp_q, coords, log_prob, split, accepted, count,
            seed, offset, log_u, leaves=(), row_unit=0):
    """Launch K2 with launch plan ``plan`` on checked arguments;
    ``leaves`` are the blob leaves' descriptors and ``row_unit`` their
    path (:func:`leaf_plan`)."""
    dev = coords.device
    ntemps = coords.shape[0] if coords.dim() == 3 else 1
    table = (_BlobLeaf * max(1, len(leaves)))(*[
        _BlobLeaf(*d) for d in leaves])
    launch(
        "accept_select", dev,
        q.data_ptr(), factor.data_ptr(), lp_q.data_ptr(),
        coords.data_ptr(), log_prob.data_ptr(), accepted.data_ptr(),
        ptr(count), ptr(log_u), q.shape[-2], coords.shape[-1], split,
        *plan, coords.shape[-2],
        *key_args(seed, dev, ntemps, injected=log_u is not None),
        *rng_args(0, offset, dev)[1:],
        ctypes.addressof(table), len(leaves), row_unit,
    )


accept_select.launches = 0
accept_select.device_launches = None
