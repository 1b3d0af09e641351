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

The accept uniform is Philox word 1 at ``(walker, split, offset)``
(``offset`` an int or a ``DeviceOffset``), or the injected ``log_u``
(ng,) (the parity mode: ``RedBlueMove._inner``'s ``log_u`` argument in
the JAX package).

:func:`accept_select` launches the kernel for CUDA tensors and uses
:func:`accept_select_plain` for CPU tensors; it never falls back from one
to the other.  ``accept_select.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from ._wrap import (
    check_f32, check_rows, device_sm_count, launch, ptr, rng_args, tile_plan)
from .philox import to_uniform, walker_words

__all__ = ["accept_select", "accept_select_plain"]


def accept_select_plain(q, factor, lp_q, coords, log_prob, split, nsplits,
                        accepted, count=None, *, seed=0, offset=0,
                        log_u=None):
    """Plain PyTorch K2; updates the buffers in place and returns the
    block's acceptance ``(ng,)`` bool (a view of ``accepted``)."""
    ng = coords.shape[0] // nsplits
    lo = split * ng
    if log_u is None:
        _, w1, _, _ = walker_words(ng, split, seed, offset, coords.device)
        log_u = torch.log(to_uniform(w1, factor.dtype))
    s = coords[lo:lo + ng]
    lp_s = log_prob[lo:lo + ng]
    lnpdiff = factor + lp_q - lp_s
    acc = log_u < lnpdiff
    s.copy_(torch.where(acc[:, None], q, s))
    lp_s.copy_(torch.where(acc, lp_q, lp_s))
    accepted[lo:lo + ng] = acc
    if count is not None:
        count[lo:lo + ng] += acc
    return accepted[lo:lo + ng]


def accept_select(q, factor, lp_q, coords, log_prob, split, nsplits,
                  accepted, count=None, *, seed=0, offset=0, log_u=None):
    """K2 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    args = (q, factor, lp_q, coords, log_prob, split, nsplits, accepted,
            count)
    kw = dict(seed=seed, offset=offset, log_u=log_u)
    if coords.device.type == "cpu":
        return accept_select_plain(*args, **kw)
    if coords.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {coords.device}")
    nw, nd, ng = check_rows(coords, split, nsplits)
    dev = coords.device
    check_f32("log_prob", log_prob, dev, (nw,))
    check_f32("q", q, dev, (ng, nd))
    check_f32("factor", factor, dev, (ng,))
    check_f32("lp_q", lp_q, dev, (ng,))
    check_f32("log_u", log_u, dev, (ng,))
    if (accepted.device != dev or accepted.dtype != torch.bool
            or tuple(accepted.shape) != (nw,) or not accepted.is_contiguous()):
        raise ValueError(f"accepted must be a contiguous ({nw},) bool "
                         f"tensor on {dev}")
    if count is not None and (
            count.device != dev or count.dtype != torch.int32
            or tuple(count.shape) != (nw,) or not count.is_contiguous()):
        raise ValueError(f"count must be a contiguous ({nw},) int32 tensor "
                         f"on {dev}")
    plan = tile_plan(ng, nd, split, device_sm_count(dev), coords.data_ptr(),
                     q.data_ptr(), stage=True)
    _launch(plan, q, factor, lp_q, coords, log_prob, split, accepted, count,
            seed, offset, log_u)
    accept_select.launches += 1
    return accepted[split * ng:(split + 1) * ng]


def _launch(plan, q, factor, lp_q, coords, log_prob, split, accepted, count,
            seed, offset, log_u):
    """Launch K2 with launch plan ``plan`` on checked arguments."""
    dev = coords.device
    launch(
        "accept_select", dev,
        q.data_ptr(), factor.data_ptr(), lp_q.data_ptr(),
        coords.data_ptr(), log_prob.data_ptr(), accepted.data_ptr(),
        ptr(count), ptr(log_u), q.shape[0], coords.shape[1], split, *plan,
        *rng_args(seed, offset, dev),
    )


accept_select.launches = 0
