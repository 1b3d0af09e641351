"""Backends for parallel-tempered chains.

The counterpart of ``emcee_tpu/backends/pt.py:36-388``: the chain-store
contract on the ``(ntemps, nwalkers)`` ladder.  The chain is ``(it, T,
nwalkers, ndim)``, with per-rung ``log_like`` and ``log_prior`` ``(it, T,
nwalkers)``, the cumulative ``accepted`` counts ``(T, nwalkers)``, the
pair-swap counters ``swaps_accepted`` and ``swaps_proposed`` ``(T - 1,)``
(one entry with one rung), the ladder ``betas`` and the random state, so
a tempered run resumes as a flat one does.  ``random_state`` is the
port's ``(seed, offset)`` pair.

:class:`PTBackend` keeps the chain in host numpy arrays;
:class:`PTDeviceBackend` keeps it in device memory (the sampler writes
each kept step into its rows, and acceptance adds up on the device), and
``get_*`` return numpy copies of the rows asked for; ``to_host`` drains it
into a host backend.  User blobs of the likelihood and
:class:`PTHDFBackend` are not ported yet (ROADMAP P11b).
"""

from __future__ import annotations

import numpy as np
import torch

from .backend import _random_state, _to_numpy

__all__ = ["PTBackend", "PTDeviceBackend", "PTHDFBackend"]


def _no_blobs(blobs):
    if blobs is not None:
        raise NotImplementedError(
            "user blobs of a tempered chain are not ported yet (ROADMAP "
            "P11b)"
        )


class PTBackend:
    """In-memory (host) store for parallel-tempered chains."""

    def __init__(self, dtype=None):
        self.initialized = False
        self.dtype = dtype or np.float64

    def reset(self, ntemps, nwalkers, ndim):
        self.ntemps = int(ntemps)
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        self.iteration = 0
        self._size = 0
        self.chain = None
        self.log_like = None
        self.log_prior = None
        self.accepted = np.zeros((self.ntemps, self.nwalkers), np.int64)
        self.swaps_accepted = np.zeros(max(self.ntemps - 1, 1), np.int64)
        self.swaps_proposed = np.zeros(max(self.ntemps - 1, 1), np.int64)
        self.random_state = None
        self.betas = None
        self.initialized = True

    @property
    def shape(self):
        return (self.ntemps, self.nwalkers, self.ndim)

    @property
    def has_blobs(self):
        return False

    def grow(self, ngrow, blobs=None):
        """Pre-allocate room for ``ngrow`` more kept steps."""
        _no_blobs(blobs)
        new_size = self.iteration + int(ngrow)
        if self.chain is not None and new_size <= self._size:
            return
        self._size = new_size

        def grown(arr, shape):
            new = np.empty((self._size,) + shape, dtype=self.dtype)
            if arr is not None:
                new[: self.iteration] = arr[: self.iteration]
            return new

        T, nw, nd = self.ntemps, self.nwalkers, self.ndim
        self.chain = grown(self.chain, (T, nw, nd))
        self.log_like = grown(self.log_like, (T, nw))
        self.log_prior = grown(self.log_prior, (T, nw))

    def save_chunk(self, coords, log_like, log_prior, accepted,
                   swaps_accepted, swaps_proposed, random_state, betas,
                   blobs=None):
        """Append a chunk of kept steps: ``coords`` ``(k, T, nwalkers,
        ndim)``, ``log_like``/``log_prior``/``accepted`` ``(k, T,
        nwalkers)``; the swap counters and ladder after it."""
        _no_blobs(blobs)
        coords = _to_numpy(coords)
        k = coords.shape[0]
        if self.chain is None or self.iteration + k > self._size:
            # Un-pre-grown: grow geometrically (amortised O(n) copying).
            self.grow(max(k, self.iteration))
        i = self.iteration
        self.chain[i: i + k] = coords
        self.log_like[i: i + k] = _to_numpy(log_like)
        self.log_prior[i: i + k] = _to_numpy(log_prior)
        self.accepted += _to_numpy(accepted).sum(axis=0)
        self.swaps_accepted = np.asarray(swaps_accepted, dtype=np.int64)
        self.swaps_proposed = np.asarray(swaps_proposed, dtype=np.int64)
        self.iteration += k
        self.random_state = _random_state(random_state)
        self.betas = np.asarray(betas, dtype=np.float64)

    def _get(self, name, discard=0, thin=1):
        if self.iteration <= 0:
            raise AttributeError(
                "you must run the sampler with 'store == True' before "
                "accessing the results"
            )
        return _to_numpy(getattr(self, name)[discard + thin - 1:
                                             self.iteration: thin])

    def get_chain(self, discard=0, thin=1, flat=False, temp=None):
        v = self._get("chain", discard, thin)
        if temp is not None:
            v = v[:, temp]
            if flat:
                return v.reshape(-1, v.shape[-1])
        return v

    def get_log_like(self, discard=0, thin=1):
        return self._get("log_like", discard, thin)

    def get_log_prior(self, discard=0, thin=1):
        return self._get("log_prior", discard, thin)

    def get_blobs(self, discard=0, thin=1, temp=None):
        return None

    def get_last_sample(self):
        from ..parallel.tempering import PTState

        it = self.iteration
        if it <= 0:
            raise AttributeError("empty backend")
        return PTState(coords=self.chain[it - 1],
                       log_like=self.log_like[it - 1],
                       log_prior=self.log_prior[it - 1],
                       random_state=self.random_state)


class PTDeviceBackend(PTBackend):
    """Device-resident store for parallel-tempered chains (the tempered
    counterpart of :class:`~.device.DeviceBackend`): the sampler writes
    each kept step into the chain's device rows, acceptance adds up on
    the device, and only the ``(T - 1,)`` swap counters cross to the
    host, once a chunk."""

    #: sampler hint: hand out device rows, not host copies
    wants_device_arrays = True

    def __init__(self, dtype=None):
        super().__init__(dtype)

    def reset(self, ntemps, nwalkers, ndim):
        super().reset(ntemps, nwalkers, ndim)
        self._acc_dev = None

    @property
    def accepted(self):
        """Cumulative per-walker acceptance counts ``(T, nwalkers)``
        (numpy int64)."""
        if self._acc_dev is None:
            return self._acc_base.copy()
        return self._acc_base + self._acc_dev.cpu().numpy()

    @accepted.setter
    def accepted(self, value):
        self._acc_base = np.array(value, dtype=np.int64)
        self._acc_dev = None

    def grow(self, ngrow, blobs=None):
        """Record the capacity a run needs; the tensors are allocated on
        the chunk's device at the next :meth:`reserve`."""
        _no_blobs(blobs)
        self._size = self.iteration + int(ngrow)

    def _grown(self, old, shape, device, dtype):
        new = torch.empty(shape, dtype=dtype, device=device)
        if old is not None:
            new[: self.iteration].copy_(old[: self.iteration])
        return new

    def reserve(self, k, device, dtype=torch.float32):
        """The chain, ``log_like`` and ``log_prior`` rows of the next
        ``k`` kept steps, as views the sampler writes each kept step into;
        they count as stored at :meth:`commit`."""
        need = self.iteration + int(k)
        if self.chain is None or need > self.chain.shape[0]:
            cap = max(need, self._size)
            T, nw, nd = self.shape
            self.chain = self._grown(self.chain, (cap, T, nw, nd), device,
                                     dtype)
            self.log_like = self._grown(self.log_like, (cap, T, nw), device,
                                        dtype)
            self.log_prior = self._grown(self.log_prior, (cap, T, nw),
                                         device, dtype)
        i = self.iteration
        return (self.chain[i:need], self.log_like[i:need],
                self.log_prior[i:need])

    def commit(self, accepted, swaps_accepted, swaps_proposed, random_state,
               betas):
        """Count the reserved rows as stored; ``accepted`` is their
        ``(k, T, nwalkers)`` acceptance, on the device."""
        acc = accepted.sum(dim=0, dtype=torch.int64)
        self._acc_dev = acc if self._acc_dev is None else self._acc_dev + acc
        self.iteration += accepted.shape[0]
        self.swaps_accepted = np.asarray(swaps_accepted, dtype=np.int64)
        self.swaps_proposed = np.asarray(swaps_proposed, dtype=np.int64)
        self.random_state = _random_state(random_state)
        self.betas = np.asarray(betas, dtype=np.float64)

    def save_chunk(self, coords, log_like, log_prior, accepted,
                   swaps_accepted, swaps_proposed, random_state, betas,
                   blobs=None):
        """Append a chunk held in tensors (numpy arrays are taken onto the
        device of the stored chain, or the CPU)."""
        _no_blobs(blobs)
        dev = (self.chain.device if self.chain is not None
               else coords.device if isinstance(coords, torch.Tensor)
               else torch.device("cpu"))

        def put(x):
            return torch.as_tensor(x, device=dev)

        coords = put(coords)
        rows = self.reserve(coords.shape[0], dev, coords.dtype)
        for dst, src in zip(rows, (coords, log_like, log_prior)):
            dst.copy_(put(src))
        self.commit(put(accepted), swaps_accepted, swaps_proposed,
                    random_state, betas)

    def get_last_sample(self):
        from ..parallel.tempering import PTState

        it = self.iteration
        if it <= 0:
            raise AttributeError("empty backend")
        return PTState(coords=self.chain[it - 1].clone(),
                       log_like=self.log_like[it - 1].clone(),
                       log_prior=self.log_prior[it - 1].clone(),
                       random_state=self.random_state)

    def to_host(self, backend=None):
        """Drain the device-resident chain into a host backend (default: a
        fresh :class:`PTBackend`), which must be empty or hold a prefix
        of this chain.  Returns the host backend."""
        if backend is None:
            backend = PTBackend()
        if not backend.initialized:
            backend.reset(self.ntemps, self.nwalkers, self.ndim)
        start = backend.iteration
        if start > self.iteration:
            raise ValueError(
                "target backend is ahead of this PTDeviceBackend "
                f"({start} > {self.iteration})"
            )
        if start < self.iteration:
            sl = slice(start, self.iteration)
            backend.save_chunk(
                _to_numpy(self.chain[sl]), _to_numpy(self.log_like[sl]),
                _to_numpy(self.log_prior[sl]),
                (self.accepted - backend.accepted)[None],
                self.swaps_accepted, self.swaps_proposed,
                self.random_state, self.betas,
            )
        return backend


class PTHDFBackend:
    """The HDF5 store of tempered chains (``emcee_tpu/backends/pt.py:
    390``): not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "PTHDFBackend is not ported yet (ROADMAP P11b)"
        )
