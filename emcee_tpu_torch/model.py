"""Log-probability model plumbing.

The counterpart of ``emcee_tpu/model.py:22-99`` (``Model``), ``:101-134``
(``_NamedParamsAdapter``), ``:136`` (``_FunctionWrapper``), ``:193-266``
(``canonicalize_output``) and ``:269`` (``wrap_log_prob_fn``).  Every
evaluation is one batched call over a group of walkers: with
``vectorize=True`` the user's function takes the ``(n, ndim)`` batch; with
``vectorize=False`` it takes one ``(ndim,)`` vector and is lifted with
``torch.func.vmap``.  The function runs eagerly between K1 and K2 as
ordinary PyTorch operations on the walkers' device.

The function may return blobs after the log-prob, as in the JAX package:
``lp``, ``(lp, blob)`` or ``(lp, blob1, blob2, ...)``, each blob a tensor
or a tuple, list or dict of tensors with the walker axis first.  A blob
that is not numeric (a string, an object array) needs host evaluation,
which is not ported (ROADMAP P12).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .utils import tree_flatten, tree_unflatten

__all__ = ["Model", "canonicalize_output", "wrap_log_prob_fn"]


class Model(NamedTuple):
    """Everything a move needs to evaluate proposals.

    Fields
    ------
    compute_log_prob:
        Batched log-prob: ``(n, ndim) -> (log_prob (n,), blobs)``; the
        blobs are a pytree of ``(n, ...)`` tensors, or None.
    nwalkers:
        Number of walkers (for the ``nwalkers >= 2 * ndim`` guard).
    ndim:
        Parameter dimensionality (the stretch move's Hastings factor).
    compute_log_prob_partial:
        The shard-local partial log-prob under parameter sharding, which
        gradient moves differentiate (``emcee_tpu/model.py:63-72``); None
        until parameter sharding is ported (ROADMAP P13).
    grad_ok:
        False for a log-prob that cannot be differentiated; gradient
        moves then raise.
    """

    compute_log_prob: Callable
    nwalkers: Optional[int] = None
    ndim: Optional[int] = None
    compute_log_prob_partial: Optional[Callable] = None
    grad_ok: bool = True

    def log_prob_for_grad(self):
        """The callable that gradient moves differentiate."""
        return self.compute_log_prob_partial or self.compute_log_prob

    def global_ndim(self, local_ndim: int) -> float:
        return self.ndim if self.ndim is not None else local_ndim


class _NamedParamsAdapter:
    """Adapt an ``x``-tensor log-prob to the named-parameter convention
    (reference ``ensemble.py:174-214, 685-700``): the user function gets a
    dict from names to scalars (one index) or vectors (an index list).
    ``x`` is one ``(ndim,)`` vector under ``torch.func.vmap``, where an
    index list must be an index tensor on ``x``'s device: one is made per
    device at the first (eager) call, so a call recorded into a CUDA
    graph copies nothing from the host.  A class, not a closure, so that
    it pickles."""

    def __init__(self, fn, key_map):
        self.fn = fn
        self.key_map = {
            key: (list(val) if isinstance(val, (list, tuple)) else int(val))
            for key, val in key_map.items()
        }
        self._index = {}

    def _indices(self, device):
        key = str(device)
        if key not in self._index:
            self._index[key] = {
                name: torch.as_tensor(val, dtype=torch.int64, device=device)
                for name, val in self.key_map.items()
                if isinstance(val, list)
            }
        return self._index[key]

    def __call__(self, x, *args, **kwargs):
        index = self._indices(x.device)
        params = {key: x[index[key]] if key in index else x[val]
                  for key, val in self.key_map.items()}
        return self.fn(params, *args, **kwargs)

    def __getstate__(self):
        return dict(self.__dict__, _index={})


class _FunctionWrapper:
    """Picklable closure over ``(fn, args, kwargs)``."""

    def __init__(self, f, args, kwargs):
        self.f = f
        self.args = args
        self.kwargs = kwargs

    def __call__(self, x):
        return self.f(x, *self.args, **self.kwargs)


def _as_leaf(v, device):
    """A blob leaf as a tensor on ``device``; Python numbers become 0-d
    tensors made by a fill (capture-safe), as JAX's weak types: a float is
    float32, an int int32, a bool bool.  A leaf that is not numeric
    raises ``NotImplementedError`` (host evaluation, ROADMAP P12)."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (bool, np.bool_)):
        return torch.full((), bool(v), dtype=torch.bool, device=device)
    if isinstance(v, (int, np.integer)):
        return torch.full((), int(v), dtype=torch.int32, device=device)
    if isinstance(v, (float, np.floating)):
        return torch.full((), float(v), dtype=torch.float32, device=device)
    if isinstance(v, np.ndarray) and v.dtype.kind in "biuf":
        return torch.as_tensor(v, device=device)
    raise NotImplementedError(
        f"a blob of type {type(v).__name__} needs host evaluation of the "
        "log-prob, which is not ported yet (ROADMAP P12); return tensors"
    )


def _reference_squeeze(blob, lead_ndim):
    """Drop size-1 axes beyond the protected leading batch axes
    (reference ``ensemble.py:541-546``)."""
    axes = [i for i in range(lead_ndim, blob.dim()) if blob.shape[i] == 1]
    for i in reversed(axes):
        blob = blob.squeeze(i)
    return blob


def _try_pack_uniform(extras, lead_ndim):
    """Stack several blob returns into one tensor when the reference's
    ``np.array(list_of_tuples)`` would make a regular array: equal shapes
    (their common dtype by promotion)."""
    if len({tuple(a.shape) for a in extras}) != 1:
        return None
    dt = extras[0].dtype
    for a in extras[1:]:
        dt = torch.promote_types(dt, a.dtype)
    stacked = torch.stack([a.to(dt) for a in extras], dim=lead_ndim)
    return _reference_squeeze(stacked, lead_ndim)


def canonicalize_output(out, reference_layout=False, lead_ndim=0,
                        device=None):
    """Split a log-prob return value into ``(log_prob, blobs)``, as
    ``emcee_tpu/model.py:193-239``: a bare tensor is a log-prob with no
    blobs; ``(lp, b)`` makes ``b`` the blob; ``(lp, b1, b2, ...)`` a
    tuple blob.  With ``reference_layout`` (the sampler's default when no
    ``blobs_dtype`` is declared) a uniform tuple of tensor blobs is
    stacked on a new axis, and size-1 axes of a single tensor blob past
    the ``lead_ndim`` batch axes are squeezed.  Dict blobs and non-uniform
    tuples stay pytrees.  Every blob leaf becomes a tensor on ``device``
    (see :func:`_as_leaf`)."""

    def leaves_to_tensors(blob):
        leaves, treedef = tree_flatten(blob)
        return tree_unflatten(treedef, [_as_leaf(v, device) for v in leaves])

    if not isinstance(out, (tuple, list)):
        return out, None
    if len(out) == 0:
        raise ValueError("log_prob_fn returned an empty tuple")
    if len(out) == 1:
        return out[0], None
    extras = [leaves_to_tensors(b) for b in out[1:]]
    if len(out) == 2:
        blob = extras[0]
        if reference_layout and isinstance(blob, torch.Tensor):
            blob = _reference_squeeze(blob, lead_ndim)
        return out[0], blob
    if reference_layout and all(isinstance(b, torch.Tensor) for b in extras):
        packed = _try_pack_uniform(extras, lead_ndim)
        if packed is not None:
            return out[0], packed
    return out[0], tuple(extras)


def wrap_log_prob_fn(log_prob_fn: Callable, *, args=None, kwargs=None,
                     vectorize: bool = False, parameter_names=None,
                     reference_blob_layout: bool = False) -> Callable:
    """Build the canonical batched log-prob callable ``q -> (lp, blobs)``.

    ``args``/``kwargs`` are passed after the coordinates.
    ``parameter_names`` (a dict from names to an index or index list,
    checked by the sampler) hands the function a dict of named
    parameters instead of ``x``.  The log-prob is cast to the
    coordinates' dtype and must hold one value per walker; every blob
    leaf must have the walker axis first.  Blob leaves keep the dtype
    the function gives them.
    """
    fn = log_prob_fn
    if parameter_names is not None:
        fn = _NamedParamsAdapter(fn, parameter_names)
    fn = _FunctionWrapper(
        fn,
        tuple(args) if args is not None else (),
        dict(kwargs) if kwargs is not None else {},
    )

    if vectorize:
        def batched(q):
            return canonicalize_output(fn(q), reference_blob_layout, 1,
                                       q.device)
    else:
        def batched(q):
            # vmap returns tensors only: the blobs cross it as leaves, and
            # their structure beside it.
            treedef = []

            def single(x):
                lp, blobs = canonicalize_output(fn(x), reference_blob_layout,
                                                0, x.device)
                leaves, d = tree_flatten(blobs)
                treedef.append(d)
                return (torch.as_tensor(lp).reshape(()),) + tuple(leaves)

            out = torch.func.vmap(single)(q)
            return out[0], tree_unflatten(treedef[0], out[1:])

    def compute_log_prob(q):
        lp, blobs = batched(q)
        n = q.shape[0]
        lp = torch.as_tensor(lp)
        if lp.numel() != n:
            raise ValueError(
                f"log_prob_fn must return shape ({n},) for a batch "
                f"of {n} walkers, got {tuple(lp.shape)}"
            )
        for leaf in tree_flatten(blobs)[0]:
            if leaf.dim() == 0 or leaf.shape[0] != n:
                raise ValueError(
                    f"every blob must have the walker axis first: ({n}, "
                    f"...) for a batch of {n} walkers, got "
                    f"{tuple(leaf.shape)}"
                )
        return lp.reshape(n).to(q.dtype), blobs

    return compute_log_prob
