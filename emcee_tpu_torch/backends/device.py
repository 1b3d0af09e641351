"""Device-resident chain backend.

The counterpart of ``emcee_tpu/backends/device.py:48-297``: the chain
stays in device memory, in preallocated ``(K, nwalkers, ndim)`` and
``(K, nwalkers)`` tensors that grow when a run asks for more kept steps.
:meth:`save_chunk` copies a chunk's device tensors in (device to
device), and the acceptance counts add up on the device.  Nothing
crosses to the host until a caller reads: ``get_chain``/
``get_log_prob``/``get_value`` return numpy copies of just the rows
asked for, ``accepted`` copies the ``(nwalkers,)`` counts, and
``get_autocorr_time`` runs the FFTs on the device, so only the
walker-averaged ACF leaves it.  :meth:`to_host` drains the chain into a
host :class:`~.backend.Backend`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..state import State
from .backend import Backend, _check_no_blobs, _random_state, _to_numpy

__all__ = ["DeviceBackend"]


class DeviceBackend(Backend):
    """Store the chain in device memory instead of host memory."""

    #: sampler hint: pass save_chunk the device tensors, not host copies
    wants_device_arrays = True

    @property
    def accepted(self):
        """Cumulative per-walker acceptance counts (numpy int64)."""
        if self._acc_dev is None:
            return self._acc_base.copy()
        return self._acc_base + self._acc_dev.cpu().numpy()

    @accepted.setter
    def accepted(self, value):
        self._acc_base = np.array(value, dtype=np.int64)
        self._acc_dev = None

    def grow(self, ngrow, blobs):
        """Record the capacity a run needs; the tensors are allocated on
        the chunk's device at the next :meth:`reserve`."""
        _check_no_blobs(blobs)
        self._size = self.iteration + int(ngrow)

    def _grown(self, old, shape, device, dtype):
        new = torch.empty(shape, dtype=dtype, device=device)
        if old is not None:
            new[: self.iteration].copy_(old[: self.iteration])
        return new

    def reserve(self, k, device, dtype):
        """The chain and log-prob rows of the next ``k`` kept steps, as
        views the sampler writes each kept step into directly; they
        count as stored once :meth:`commit` is called."""
        need = self.iteration + int(k)
        if self.chain is None or need > self.chain.shape[0]:
            cap = max(need, self._size)
            self.chain = self._grown(
                self.chain, (cap, self.nwalkers, self.ndim), device, dtype
            )
            self.log_prob = self._grown(
                self.log_prob, (cap, self.nwalkers), device, dtype
            )
        i = self.iteration
        return self.chain[i:need], self.log_prob[i:need]

    def commit(self, accepted, random_state):
        """Count the ``k`` reserved rows as stored; ``accepted`` is the
        ``(k, nwalkers)`` acceptance of their proposals, on the device."""
        acc = accepted.sum(dim=0, dtype=torch.int64)
        self._acc_dev = acc if self._acc_dev is None else self._acc_dev + acc
        self.iteration += accepted.shape[0]
        self.random_state = _random_state(random_state)

    def save_chunk(self, coords, log_prob, blobs, accepted, random_state):
        """Append a chunk of kept steps held in device tensors."""
        _check_no_blobs(blobs)
        chain, lp = self.reserve(coords.shape[0], coords.device, coords.dtype)
        chain.copy_(coords)
        lp.copy_(log_prob)
        self.commit(accepted, random_state)

    def get_value(self, name, flat=False, thin=1, discard=0):
        out = self._slice(name, flat, thin, discard)
        return None if out is None else _to_numpy(out)

    def get_last_sample(self) -> State:
        if (not self.initialized) or self.iteration <= 0:
            raise AttributeError(
                "you must run the sampler with 'store == True' before "
                "accessing the results"
            )
        it = self.iteration
        return State(
            coords=self.chain[it - 1].clone(),
            log_prob=self.log_prob[it - 1].clone(),
            random_state=self.random_state,
        )

    def to_host(self, backend=None):
        """Drain the device-resident chain into a host backend (default: a
        fresh :class:`Backend`), which must be empty or hold a prefix of
        this chain.  Returns the host backend."""
        if backend is None:
            backend = Backend()
        if not backend.initialized:
            backend.reset(self.nwalkers, self.ndim)
        start = backend.iteration
        if start > self.iteration:
            raise ValueError(
                "target backend is ahead of this DeviceBackend "
                f"({start} > {self.iteration})"
            )
        if start < self.iteration:
            sl = slice(start, self.iteration)
            accepted = (self.accepted - backend.accepted)[None]
            backend.save_chunk(
                _to_numpy(self.chain[sl]),
                _to_numpy(self.log_prob[sl]),
                None,
                accepted,
                self.random_state,
            )
        return backend
