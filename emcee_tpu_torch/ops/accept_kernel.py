"""K2: the accept/select write-back, as a CUDA kernel and as plain PyTorch.

Held against ``emcee_tpu/moves/red_blue.py:196-204`` (``_inner``: the
Metropolis compare and select) and ``:323-344`` (the write-back of the
selected rows into the ensemble).  The kernel is
``csrc/accept_select.cu``; its note says what bounds it on the card.

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

from ._wrap import check_f32, check_rows, launch, ptr, rng_args
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
    launch(
        "accept_select", dev,
        q.data_ptr(), factor.data_ptr(), lp_q.data_ptr(),
        coords.data_ptr(), log_prob.data_ptr(), accepted.data_ptr(),
        ptr(count), ptr(log_u), ng, nd, split, *rng_args(seed, offset, dev),
    )
    accept_select.launches += 1
    return accepted[split * ng:(split + 1) * ng]


accept_select.launches = 0
