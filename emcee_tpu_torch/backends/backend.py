"""In-memory (host) chain backend.

The counterpart of ``emcee_tpu/backends/backend.py:43-296`` and the
reference ``Backend``: chain ``(iteration, nwalkers, ndim)``, log-prob
``(iteration, nwalkers)``, optional blobs (a pytree of ``(iteration,
nwalkers, ...)`` arrays, each leaf in its own dtype), cumulative
per-walker ``accepted`` counts and the sampler's generator state, in
numpy arrays on the host.  The sampler lands a whole chunk of kept steps
per :meth:`save_chunk`.  ``random_state`` is the port's ``(seed,
offset)`` pair.

:meth:`save_chunk` copies the rows with torch's CPU copy, on torch's
intra-op threads: a chunk of the main path is ~5 MB of new rows per
kept step, and writing pages touched for the first time is the stored
run's bound on the host; the threads take those page faults in parallel
(``chip_smoke.py`` phase 4's split, ``PERF.md``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import autocorr
from ..state import State
from ..utils import tree_leaves, tree_map

__all__ = ["Backend"]


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _write_rows(dst, src):
    """``dst[...] = src`` for a numpy view ``dst``, on torch's threads
    (numpy's assignment where torch does not take the arrays)."""
    src = _to_numpy(src)
    try:
        torch.from_numpy(dst).copy_(
            torch.from_numpy(np.require(src, requirements="W")))
    except (TypeError, ValueError, RuntimeError):  # a dtype or layout
        dst[...] = src                              # torch refuses


def _check_blob_consistency(iteration, has_blobs, blobs):
    """A store's blob structure is fixed by its first save: a blob-ful
    chain continued without blobs, or a blob-less one with blobs, raises
    (reference ``backend.py:158-162``).  The first direction errors at
    any iteration (a ``grow`` with a template makes the store blob-ful
    before its first save); the second only once rows exist."""
    if bool(has_blobs) and blobs is None:
        raise ValueError("inconsistent use of blobs")
    if iteration > 0 and blobs is not None and not bool(has_blobs):
        raise ValueError("inconsistent use of blobs")


def _pack_declared_blobs(blobs, declared):
    """A walker row's blob leaves as one structured array when the
    sampler declared a named ``blobs_dtype`` (the reference's
    ``State.blobs`` is then the record array); the leaves otherwise."""
    if blobs is None or declared is None:
        return blobs
    declared = np.dtype(declared)
    if declared.names is None:
        return blobs
    leaves = [_to_numpy(x) for x in tree_leaves(blobs)]
    if len(leaves) != len(declared.names):
        return blobs
    dtype = np.dtype([(name, declared[name].base, leaf.shape[1:])
                      for name, leaf in zip(declared.names, leaves)])
    out = np.empty(leaves[0].shape[0], dtype=dtype)
    for name, leaf in zip(declared.names, leaves):
        out[name] = leaf
    return out


def _random_state(rs):
    return None if rs is None else (int(rs[0]), int(rs[1]))


class Backend:
    """A simple default backend that stores the chain in host memory."""

    def __init__(self, dtype=None):
        self.initialized = False
        self.dtype = dtype

    def __enter__(self):
        return self

    def __exit__(self, exception_type, exception_value, traceback):
        pass

    def reset(self, nwalkers, ndim):
        """Clear the state of the chain and empty the backend."""
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        self.iteration = 0
        self.accepted = np.zeros(self.nwalkers, dtype=np.int64)
        self.chain = None
        self.log_prob = None
        self.blobs = None
        self.random_state = None
        self.initialized = True
        self._size = 0

    @property
    def shape(self):
        return (self.nwalkers, self.ndim)

    @property
    def has_blobs(self):
        return self.blobs is not None

    def grow(self, ngrow, blobs):
        """Pre-allocate space for ``ngrow`` more steps.

        Args:
            ngrow: number of steps to grow by.
            blobs: an example blob pytree (leaves ``(nwalkers, ...)``, in
                the dtypes to store) or None, used to allocate blob
                storage on first growth.
        """
        _check_blob_consistency(self.iteration, self.has_blobs, blobs)
        self._size = self.iteration + int(ngrow)
        dtype = self.dtype or np.float64
        if self.chain is not None:
            dtype = self.chain.dtype

        def grown(arr, shape, dt):
            new = np.empty((self._size,) + tuple(shape), dtype=dt)
            if arr is not None:
                new[: self.iteration] = arr[: self.iteration]
            return new

        self.chain = grown(self.chain, (self.nwalkers, self.ndim), dtype)
        self.log_prob = grown(self.log_prob, (self.nwalkers,), dtype)
        if blobs is not None:
            example = tree_map(_to_numpy, blobs)
            if self.blobs is None:
                self.blobs = tree_map(
                    lambda b: grown(None, b.shape, b.dtype), example)
            else:
                self.blobs = tree_map(
                    lambda old, b: grown(old, b.shape, b.dtype), self.blobs,
                    example)

    def save_chunk(self, coords, log_prob, blobs, accepted, random_state):
        """Append a chunk of kept steps.

        Args:
            coords: ``(k, nwalkers, ndim)``
            log_prob: ``(k, nwalkers)``
            blobs: a pytree of ``(k, nwalkers, ...)`` arrays, or None
            accepted: ``(k, nwalkers)`` bool, each kept step's acceptance
            random_state: the post-chunk ``(seed, offset)``
        """
        _check_blob_consistency(self.iteration, self.has_blobs, blobs)
        coords = _to_numpy(coords)
        k = coords.shape[0]
        if (self.chain is None or self.iteration + k > self._size
                or (blobs is not None and self.blobs is None)):
            example = (None if blobs is None
                       else tree_map(lambda b: _to_numpy(b)[0], blobs))
            self.grow(max(k, self._size - self.iteration, 1), example)
        i = self.iteration
        _write_rows(self.chain[i : i + k], coords)
        _write_rows(self.log_prob[i : i + k], log_prob)
        if blobs is not None:
            for store, b in zip(tree_leaves(self.blobs), tree_leaves(blobs)):
                _write_rows(store[i : i + k], b)
        self.accepted += _to_numpy(accepted).sum(axis=0)
        self.iteration += k
        self.random_state = _random_state(random_state)

    def save_step(self, state, accepted):
        """Single-step compatibility wrapper (reference ``save_step``)."""
        blobs = (None if state.blobs is None
                 else tree_map(lambda b: _to_numpy(b)[None], state.blobs))
        self.save_chunk(
            _to_numpy(state.coords)[None], _to_numpy(state.log_prob)[None],
            blobs, _to_numpy(accepted)[None], state.random_state,
        )

    def _slice(self, name, flat=False, thin=1, discard=0):
        """The stored rows ``discard + thin - 1 :: thin`` of ``name``, as
        held (None for blobs of a blob-less store)."""
        if self.iteration <= 0:
            raise AttributeError(
                "you must run the sampler with 'store == True' before "
                "accessing the results"
            )
        if name == "blobs" and not self.has_blobs:
            return None
        if name == "chain":
            v = self.chain
        elif name == "log_prob":
            v = self.log_prob
        elif name == "blobs":
            v = self.blobs
        else:
            raise ValueError(f"unrecognized value name: {name}")

        def rows(leaf):
            out = leaf[discard + thin - 1 : self.iteration : thin]
            if flat:
                out = out.reshape((-1,) + tuple(out.shape[2:]))
            return out

        return tree_map(rows, v)

    def get_value(self, name, flat=False, thin=1, discard=0):
        return self._slice(name, flat, thin, discard)

    def get_chain(self, **kwargs):
        return self.get_value("chain", **kwargs)

    def get_log_prob(self, **kwargs):
        return self.get_value("log_prob", **kwargs)

    def get_blobs(self, **kwargs):
        return self.get_value("blobs", **kwargs)

    def get_last_sample(self) -> State:
        """The most recent chain sample as a :class:`State`; its blobs are
        packed into the declared record row when the sampler named their
        fields."""
        if (not self.initialized) or self.iteration <= 0:
            raise AttributeError(
                "you must run the sampler with 'store == True' before "
                "accessing the results"
            )
        it = self.iteration
        blobs = None
        if self.has_blobs:
            blobs = _pack_declared_blobs(
                tree_map(lambda b: b[it - 1], self.blobs),
                getattr(self, "blobs_dtype", None))
        return State(
            coords=self.chain[it - 1],
            log_prob=self.log_prob[it - 1],
            blobs=blobs,
            random_state=self.random_state,
        )

    def get_autocorr_time(self, discard=0, thin=1, **kwargs):
        x = self._slice("chain", thin=thin, discard=discard)
        return thin * autocorr.integrated_time(x, **kwargs)

