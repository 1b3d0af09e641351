"""In-memory (host) chain backend.

The counterpart of ``emcee_tpu/backends/backend.py:93-296`` and the
reference ``Backend``: chain ``(iteration, nwalkers, ndim)``, log-prob
``(iteration, nwalkers)``, cumulative per-walker ``accepted`` counts and
the sampler's generator state, in numpy arrays on the host.  The sampler
lands a whole chunk of kept steps per :meth:`save_chunk`.
``random_state`` is the port's ``(seed, offset)`` pair.  Blobs are not
ported yet (ROADMAP P10).

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
    except (TypeError, ValueError):  # a dtype or layout torch refuses
        dst[...] = src


def _check_no_blobs(blobs):
    if blobs is not None:
        raise NotImplementedError("blobs are not ported yet (ROADMAP P10)")


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
        self.random_state = None
        self.initialized = True
        self._size = 0

    @property
    def shape(self):
        return (self.nwalkers, self.ndim)

    @property
    def has_blobs(self):
        return False

    def grow(self, ngrow, blobs):
        """Pre-allocate space for ``ngrow`` more steps."""
        _check_no_blobs(blobs)
        self._size = self.iteration + int(ngrow)
        dtype = self.dtype or np.float64
        if self.chain is not None:
            dtype = self.chain.dtype

        def grown(arr, shape):
            new = np.empty((self._size,) + shape, dtype=dtype)
            if arr is not None:
                new[: self.iteration] = arr[: self.iteration]
            return new

        self.chain = grown(self.chain, (self.nwalkers, self.ndim))
        self.log_prob = grown(self.log_prob, (self.nwalkers,))

    def save_chunk(self, coords, log_prob, blobs, accepted, random_state):
        """Append a chunk of kept steps.

        Args:
            coords: ``(k, nwalkers, ndim)``
            log_prob: ``(k, nwalkers)``
            blobs: must be None
            accepted: ``(k, nwalkers)`` bool, each kept step's acceptance
            random_state: the post-chunk ``(seed, offset)``
        """
        _check_no_blobs(blobs)
        coords = _to_numpy(coords)
        k = coords.shape[0]
        if self.chain is None or self.iteration + k > self._size:
            self.grow(max(k, 1), None)
        i = self.iteration
        _write_rows(self.chain[i : i + k], coords)
        _write_rows(self.log_prob[i : i + k], log_prob)
        self.accepted += _to_numpy(accepted).sum(axis=0)
        self.iteration += k
        self.random_state = _random_state(random_state)

    def save_step(self, state, accepted):
        """Single-step compatibility wrapper (reference ``save_step``)."""
        self.save_chunk(
            state.coords[None], state.log_prob[None], state.blobs,
            accepted[None], state.random_state,
        )

    def _slice(self, name, flat=False, thin=1, discard=0):
        """The stored rows ``discard + thin - 1 :: thin`` of ``name``, as
        held (None for blobs)."""
        if self.iteration <= 0:
            raise AttributeError(
                "you must run the sampler with 'store == True' before "
                "accessing the results"
            )
        if name == "blobs":
            return None
        if name == "chain":
            v = self.chain
        elif name == "log_prob":
            v = self.log_prob
        else:
            raise ValueError(f"unrecognized value name: {name}")
        out = v[discard + thin - 1 : self.iteration : thin]
        if flat:
            out = out.reshape((-1,) + tuple(out.shape[2:]))
        return out

    def get_value(self, name, flat=False, thin=1, discard=0):
        return self._slice(name, flat, thin, discard)

    def get_chain(self, **kwargs):
        return self.get_value("chain", **kwargs)

    def get_log_prob(self, **kwargs):
        return self.get_value("log_prob", **kwargs)

    def get_blobs(self, **kwargs):
        return self.get_value("blobs", **kwargs)

    def get_last_sample(self) -> State:
        """The most recent chain sample as a :class:`State`."""
        if (not self.initialized) or self.iteration <= 0:
            raise AttributeError(
                "you must run the sampler with 'store == True' before "
                "accessing the results"
            )
        it = self.iteration
        return State(
            coords=self.chain[it - 1],
            log_prob=self.log_prob[it - 1],
            random_state=self.random_state,
        )

    def get_autocorr_time(self, discard=0, thin=1, **kwargs):
        x = self._slice("chain", thin=thin, discard=discard)
        return thin * autocorr.integrated_time(x, **kwargs)
