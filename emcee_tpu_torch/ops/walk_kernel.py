"""K18: the walk move's proposals, as CUDA kernels and as plain PyTorch.

Held against ``emcee_tpu/moves/walk.py:73-97`` (``WalkMove.get_proposal``:
the shared covariance's step ``q = s + adj (z L^T)`` and each walker's
subset step), vmapped over a ladder by ``emcee_tpu/parallel/
tempering.py:449-541``.  The kernels are ``csrc/walk_propose.cu``:

* **K18a** :func:`walk_propose`: one thread a walker draws its ``nd``
  normals at ``(row, NORMAL_BLOCK | k)``, ``row = split * ng + g`` (or
  reads them injected) and forms ``q_d = s_d + adj sum_{k <= d} z_k
  L[d, k]``, ``k`` in column order.  ``L`` is the split's factor, K8a and
  K8b's walk mode (``ops/dime_kernel.py``), ``adj`` the tuned scale.
* **K18b** :func:`walk_subset`: each walker's ``s0`` picks of the
  complement (the ``s0`` smallest of its ``nc`` uniforms at ``(row,
  PICK_BLOCK | k)``, ties by index, where ``nc <= exact_subset_max``;
  else bootstrap picks ``min(int(u nc), nc - 1)`` from the same
  counters), the subset's mean (summed in pick order), ``dz_d = sum_k
  z_k (x_k - mean)_d / sqrt(s0 - 1)`` (the ``k``-th normal beside the
  ``k``-th pick) and ``q = s + adj dz``.  A block stages its walkers'
  picks and normals in shared memory (:func:`subset_walkers`; where one
  walker's do not fit, a thread a walker and column draws them as it
  sums).  An exact subset of at most :data:`SORT_MAX` rows is sorted by
  one block a walker in shared memory;
  a larger one's keys are written by the kernel (``walk_keys``), sorted
  by K16 (``shuffle_kernel.sorted_words``, its long route) a range of
  walkers at a time, and read back as the picks.

Every sum runs from +0.0 in a fixed order and every operation rounds
once, so on the card each kernel equals its plain version bit for bit
(the plain versions divide only by tensors).  The plain versions draw the
same numbers (``plain=True``, the torch rounds of ``ops/philox.py``) and
sort with ``torch.argsort(stable=True)``.

On the rung axis ``x`` is ``(T, nw, nd)``, ``L`` ``(T, nd, nd)``,
``scale`` ``(T,)`` and ``seed`` the rungs' :class:`~.philox.RungKeys`:
every rung in one launch, each rung computed as alone.

What bounds them on an H100: bytes (K18a: ``s`` in and ``q`` out, about
2 MB of a split at 1e5 x 5; K18b: the picked rows, a 32-byte sector each),
and for the exact sort the network's compare-swaps.

Each wrapper launches its kernels for CUDA tensors and runs the plain
version for CPU tensors; it never falls back, and counts its launches in
``<wrapper>.launches`` (and ``<wrapper>.device_launches`` when set:
``_wrap.count_launches``).
"""

from __future__ import annotations

import ctypes

import torch

from . import shuffle_kernel
from ._wrap import check_f32, complement_rows, count_launches, key_args
from ._wrap import launch, ptr, rng_args
from .dime_kernel import _num
from .philox import RungKeys, normals, row_uniforms, rung_keys

__all__ = ["SORT_MAX", "SORT_BUDGET", "STAGED_SMEM", "subset_walkers",
           "walk_propose", "walk_propose_plain", "walk_subset",
           "walk_subset_plain"]

#: the longest exact subset one block sorts in shared memory (kSortMax in
#: csrc/walk_propose.cu): 4096 8-byte words, 32 KB
SORT_MAX = 4096
#: keys a range of walkers of a larger exact subset holds at once (its
#: keys, K16's sorted words and K16's scratch: 32 bytes a key, 512 MB)
SORT_BUDGET = 1 << 24
#: threads a block of K18a and of K18b's routes 0 and 2
THREADS = 128
#: threads of K18b's sorting block, at most
SORT_THREADS_MAX = 512
#: K16 sorts at most this many segments a launch (the grid's second axis)
_SEGMENTS_MAX = 65535
#: the shared memory a block of K18b's routes 0 and 2 stages its walkers'
#: picks and normals in, at most (kStagedMax in csrc/walk_propose.cu)
STAGED_SMEM = 48 * 1024


def subset_walkers(s0, nd):
    """Walkers a block of K18b's routes 0 and 2 stages: about a block's
    threads worth of (walker, column) sums, as many as fit
    :data:`STAGED_SMEM` with ``s0`` picks and normals each; 0 where one
    walker's do not fit (then a thread a walker and column draws as it
    sums)."""
    fit = STAGED_SMEM // (8 * s0)
    return min(max(1, THREADS // nd), fit)


def _layout(x, nsplits, split):
    """``(lead, nw, nd, ng)`` of a ``(nw, nd)`` / ``(T, nw, nd)`` buffer."""
    if x.dim() not in (2, 3):
        raise ValueError("x must be (nwalkers, ndim) or (T, nwalkers, ndim)")
    lead = tuple(int(t) for t in x.shape[:-2])
    nw, nd = (int(t) for t in x.shape[-2:])
    if nsplits < 2 or nw % nsplits or not 0 <= split < nsplits:
        raise ValueError(f"bad split {split} of {nsplits} for {nw} walkers")
    return lead, nw, nd, nw // nsplits


def _rung_seed(seed, lead, dev):
    """A :class:`RungKeys` for a rung axis given an int seed."""
    if lead and not isinstance(seed, RungKeys):
        return rung_keys(seed, lead[0], dev)
    return seed


def _step(s, dz, scale):
    """``s + adj dz`` (``s + dz`` untuned)."""
    if scale is None:
        return s + dz
    return s + scale.reshape(scale.shape + (1, 1)) * dz


# -- K18a -----------------------------------------------------------------


def walk_propose_plain(x, split, nsplits, L, seed, offset, scale=None,
                       z=None):
    """Plain PyTorch K18a: ``(q, factor)`` of group ``split`` of ``x``
    from the factor ``L`` (``(nd, nd)``, or ``(T, nd, nd)`` on the rung
    axis), drawn under ``seed`` at ``offset`` (``z`` ``(..., ng, nd)``
    injects the normals); ``scale`` ``()`` or ``(T,)``, or None."""
    lead, _, nd, ng = _layout(x, nsplits, split)
    dev, dt = x.device, x.dtype
    row0 = split * ng
    if z is None:
        z = normals(ng, nd, _rung_seed(seed, lead, dev), offset, dev, dt,
                    row0=row0, plain=True)
    z = z.to(dt)
    L = L.to(dt)
    acc = torch.zeros(lead + (ng, nd), dtype=dt, device=dev)
    for k in range(nd):
        acc[..., k:] = acc[..., k:] + z[..., k:k + 1] * L[..., None, k:, k]
    s = x[..., row0:row0 + ng, :]
    return _step(s, acc, scale), torch.zeros(lead + (ng,), dtype=dt,
                                             device=dev)


class _Args(ctypes.Structure):
    """The arguments of the entry points (``WalkArgs`` in
    ``csrc/walk_propose.cu``, field for field)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "q", "factor", "L", "scale", "z_in", "picks", "keys_out",
        "offset_dev", "keys")
    ] + [("offset_inc", ctypes.c_ulonglong), ("seed", ctypes.c_ulonglong)] + [
        (name, ctypes.c_int) for name in (
            "nw", "nd", "ng", "split", "ntemps", "s0", "nc", "route", "f0",
            "count", "pick_stride", "walkers", "threads")]


def _args(x, q, factor, split, nd, ng, seed, offset, lead, injected,
          **kw):
    dev = x.device
    ntemps = lead[0] if lead else 1
    ntemps, keys, seed64 = key_args(seed, dev, ntemps, injected=injected)
    _, off_ptr, off = rng_args(0, offset, dev)
    return _Args(x=x.data_ptr(), q=q.data_ptr(), factor=factor.data_ptr(),
                 offset_dev=off_ptr, keys=keys, offset_inc=off, seed=seed64,
                 nw=x.shape[-2], nd=nd, ng=ng, split=split, ntemps=ntemps,
                 f0=0, count=ntemps * ng, threads=THREADS, **kw)


def _check_common(x, split, nsplits, scale):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no K18 kernel for device {dev}")
    lead, nw, nd, ng = _layout(x, nsplits, split)
    check_f32("x", x, dev)
    if x.numel() >= 2**31 or (lead and not 1 <= lead[0] < 65536):
        raise ValueError(f"bad K18 shape {tuple(x.shape)}")
    check_f32("scale", scale, dev, lead)
    return dev, lead, nw, nd, ng


def walk_propose(x, split, nsplits, L, seed, offset, scale=None, z=None):
    """K18a on the rows' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Arguments as
    :func:`walk_propose_plain`."""
    if x.device.type == "cpu":
        return walk_propose_plain(x, split, nsplits, L, seed, offset, scale,
                                  z)
    dev, lead, _, nd, ng = _check_common(x, split, nsplits, scale)
    check_f32("L", L, dev, lead + (nd, nd))
    check_f32("z", z, dev, None if z is None else lead + (ng, nd))
    q = torch.empty(lead + (ng, nd), dtype=torch.float32, device=dev)
    factor = torch.empty(lead + (ng,), dtype=torch.float32, device=dev)
    args = _args(x, q, factor, split, nd, ng, seed, offset, lead,
                 z is not None, L=L.data_ptr(), scale=ptr(scale),
                 z_in=ptr(z))
    launch("walk_propose", dev, ctypes.addressof(args))
    count_launches(walk_propose)
    return q, factor


walk_propose.launches = 0
walk_propose.device_launches = None


# -- K18b -----------------------------------------------------------------


def _picks_plain(ng, nc, s0, exact_max, seed, offset, dev, row0):
    """Each walker's ``s0`` complement indices: the exact subset by a stable
    argsort of its ``nc`` uniforms, or bootstrap picks."""
    if nc <= exact_max:
        keys = row_uniforms(ng, nc, seed, offset, dev, row0=row0, plain=True)
        return torch.argsort(keys, dim=-1, stable=True)[..., :s0]
    u = row_uniforms(ng, s0, seed, offset, dev, row0=row0, plain=True)
    return torch.clamp((u * nc).to(torch.int64), max=nc - 1)


def walk_subset_plain(x, split, nsplits, s0, exact_max, seed, offset,
                      scale=None, z=None, picks=None):
    """Plain PyTorch K18b: ``(q, factor)`` of group ``split`` of ``x`` from
    each walker's ``s0`` picks of the complement (the exact subset where
    ``nc <= exact_max``, else bootstrap), drawn under ``seed`` at
    ``offset``.  ``z`` ``(..., ng, s0)`` and ``picks`` ``(..., ng, s0)``
    (int64 complement indices) inject the draws."""
    lead, nw, nd, ng = _layout(x, nsplits, split)
    dev, dt = x.device, x.dtype
    nc = nw - ng
    row0 = split * ng
    seed = _rung_seed(seed, lead, dev)
    if picks is None:
        picks = _picks_plain(ng, nc, s0, exact_max, seed, offset, dev, row0)
    if z is None:
        z = normals(ng, s0, seed, offset, dev, dt, row0=row0, plain=True)
    z = z.to(dt)
    rows = complement_rows(picks.to(torch.int64), split, ng)
    sub = torch.take_along_dim(x, rows.reshape(lead + (ng * s0, 1)),
                               dim=-2).reshape(lead + (ng, s0, nd))
    m = torch.zeros(lead + (ng, nd), dtype=dt, device=dev)
    for k in range(s0):
        m = m + sub[..., k, :]
    m = m / _num(s0, m)
    acc = torch.zeros_like(m)
    for k in range(s0):
        acc = acc + z[..., k:k + 1] * (sub[..., k, :] - m)
    dz = acc / torch.sqrt(_num(s0 - 1, acc))
    s = x[..., row0:row0 + ng, :]
    return _step(s, dz, scale), torch.zeros(lead + (ng,), dtype=dt,
                                            device=dev)


def walk_subset(x, split, nsplits, s0, exact_max, seed, offset, scale=None,
                z=None, picks=None):
    """K18b on the rows' device: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors.  Arguments as
    :func:`walk_subset_plain`.  Launches: one (bootstrap, an exact subset
    of at most :data:`SORT_MAX` rows, or injected picks); a larger exact
    subset takes two a range of walkers (keys, then the step) beside
    K16's sort of the range."""
    if x.device.type == "cpu":
        return walk_subset_plain(x, split, nsplits, s0, exact_max, seed,
                                 offset, scale, z, picks)
    dev, lead, nw, nd, ng = _check_common(x, split, nsplits, scale)
    nc = nw - ng
    s0 = int(s0)
    if not 1 <= s0 < nc:
        raise ValueError(f"a subset of {s0} of {nc} complement rows")
    check_f32("z", z, dev, None if z is None else lead + (ng, s0))
    if picks is not None and (picks.device != dev
                              or picks.dtype != torch.int64
                              or tuple(picks.shape) != lead + (ng, s0)
                              or not picks.is_contiguous()):
        raise ValueError(f"picks must be a contiguous {lead + (ng, s0)} "
                         f"int64 tensor on {dev}")
    q = torch.empty(lead + (ng, nd), dtype=torch.float32, device=dev)
    factor = torch.empty(lead + (ng,), dtype=torch.float32, device=dev)
    exact = nc <= int(exact_max)
    injected = z is not None and (picks is not None)
    args = _args(x, q, factor, split, nd, ng, seed, offset, lead, injected,
                 scale=ptr(scale), z_in=ptr(z), s0=s0, nc=nc)
    args.walkers = subset_walkers(s0, nd)
    if picks is not None:
        args.route, args.picks, args.pick_stride = 2, picks.data_ptr(), s0
    elif not exact:
        args.route = 0
    elif nc <= SORT_MAX:
        p = 2
        while p < nc:
            p *= 2
        args.route = 1
        args.threads = min(SORT_THREADS_MAX, max(32, p // 2))
    else:
        _long_exact(args, nc, dev)
        return q, factor
    launch("walk_subset", dev, ctypes.addressof(args))
    count_launches(walk_subset)
    return q, factor


def _long_exact(args, nc, dev):
    """An exact subset of more than :data:`SORT_MAX` rows: a range of
    walkers at a time (at most :data:`SORT_BUDGET` keys and K16's segment
    limit), the kernel writes their keys, K16 sorts them into words and
    the kernel reads each walker's first ``s0`` as its picks."""
    total = args.count
    chunk = max(1, min(_SEGMENTS_MAX, SORT_BUDGET // nc, total))
    keys = torch.empty((chunk, nc), dtype=torch.int64, device=dev)
    words = torch.empty_like(keys)
    for f0 in range(0, total, chunk):
        n = min(chunk, total - f0)
        args.f0, args.count, args.route = f0, n, 2
        args.keys_out, args.picks, args.pick_stride = (keys.data_ptr(),
                                                       words.data_ptr(), nc)
        launch("walk_keys", dev, ctypes.addressof(args))
        shuffle_kernel.sorted_words(keys[:n], words[:n])
        launch("walk_subset", dev, ctypes.addressof(args))
        count_launches(walk_subset, 2)


walk_subset.launches = 0
walk_subset.device_launches = None
