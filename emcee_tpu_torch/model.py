"""Log-probability model plumbing.

The counterpart of ``emcee_tpu/model.py:22-99`` (``Model``), ``:136``
(``_FunctionWrapper``) and ``:269`` (``wrap_log_prob_fn``).  Every
evaluation is one batched call over a group of walkers: with
``vectorize=True`` the user's function takes the ``(n, ndim)`` batch; with
``vectorize=False`` it takes one ``(ndim,)`` vector and is lifted with
``torch.func.vmap``.  The function runs eagerly between K1 and K2 as
ordinary PyTorch operations on the walkers' device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["Model", "wrap_log_prob_fn"]


class Model(NamedTuple):
    """Everything a move needs to evaluate proposals.

    Fields
    ------
    compute_log_prob:
        Batched log-prob: ``(n, ndim) -> (log_prob (n,), None)``; the
        second slot is the blobs slot, always ``None`` in this slice.
    nwalkers:
        Number of walkers (for the ``nwalkers >= 2 * ndim`` guard).
    ndim:
        Parameter dimensionality (the stretch move's Hastings factor).
    """

    compute_log_prob: Callable
    nwalkers: Optional[int] = None
    ndim: Optional[int] = None

    def global_ndim(self, local_ndim: int) -> float:
        return self.ndim if self.ndim is not None else local_ndim


class _FunctionWrapper:
    """Picklable closure over ``(fn, args, kwargs)``."""

    def __init__(self, f, args, kwargs):
        self.f = f
        self.args = args
        self.kwargs = kwargs

    def __call__(self, x):
        return self.f(x, *self.args, **self.kwargs)


def wrap_log_prob_fn(log_prob_fn: Callable, *, args=None, kwargs=None,
                     vectorize: bool = False) -> Callable:
    """Build the canonical batched log-prob callable ``q -> (lp, None)``.

    ``args``/``kwargs`` are passed after the coordinates.  The result is
    cast to the coordinates' dtype and must have shape ``(n,)``; a
    function that returns a tuple (blobs) raises ``NotImplementedError``.
    """
    fn = _FunctionWrapper(
        log_prob_fn,
        tuple(args) if args is not None else (),
        dict(kwargs) if kwargs is not None else {},
    )
    batched = fn if vectorize else torch.func.vmap(fn)

    def compute_log_prob(q):
        out = batched(q)
        if isinstance(out, (tuple, list)):
            raise NotImplementedError(
                "log_prob_fn returned a tuple: blobs are not ported yet "
                "(ROADMAP P10)"
            )
        lp = torch.as_tensor(out)
        if tuple(lp.shape) != (q.shape[0],):
            raise ValueError(
                f"log_prob_fn must return shape ({q.shape[0]},) for a batch "
                f"of {q.shape[0]} walkers, got {tuple(lp.shape)}"
            )
        return lp.to(q.dtype), None

    return compute_log_prob
