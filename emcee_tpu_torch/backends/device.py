"""Device-resident chain backend.

The counterpart of ``emcee_tpu/backends/device.py:48-297``: the chain
stays in device memory, in preallocated ``(K, nwalkers, ndim)`` and
``(K, nwalkers)`` tensors (and one ``(K, nwalkers, ...)`` tensor per blob
leaf, in the leaf's dtype) that grow when a run asks for more kept
steps.  :meth:`save_chunk` copies a chunk's tensors in (device to
device), and the acceptance counts add up on the device.  Nothing
crosses to the host until a caller reads: ``get_chain``/
``get_log_prob``/``get_blobs``/``get_value`` return numpy copies of just
the rows asked for, ``accepted`` copies the ``(nwalkers,)`` counts, and
``get_autocorr_time`` runs the FFTs on the device, so only the
walker-averaged ACF leaves it.  :meth:`to_host` drains the chain into a
host :class:`~.backend.Backend`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..driver import torch_dtype
from ..state import State
from ..utils import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .backend import (
    Backend, _check_blob_consistency, _pack_declared_blobs, _random_state,
    _to_numpy)

__all__ = ["DeviceBackend"]


class DeviceBackend(Backend):
    """Store the chain in device memory instead of host memory."""

    #: sampler hint: pass save_chunk the device tensors, not host copies
    wants_device_arrays = True

    def reset(self, nwalkers, ndim):
        super().reset(nwalkers, ndim)
        self._blob_template = None

    @property
    def has_blobs(self):
        return self.blobs is not None or self._blob_template is not None

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
        """Record the capacity a run needs and, the first time blobs
        appear, their template (the leaves' row shapes and stored
        dtypes); the tensors are allocated on the chunk's device at the
        next :meth:`reserve`."""
        _check_blob_consistency(self.iteration, self.has_blobs, blobs)
        self._size = self.iteration + int(ngrow)
        if blobs is not None and self._blob_template is None:
            leaves, treedef = tree_flatten(blobs)
            self._blob_template = (treedef, [
                (tuple(b.shape), torch_dtype(b.dtype)) for b in leaves])

    def _grown(self, old, shape, device, dtype):
        new = torch.empty(shape, dtype=dtype, device=device)
        if old is not None:
            new[: self.iteration].copy_(old[: self.iteration])
        return new

    def reserve(self, k, device, dtype, lp_dtype=None):
        """The chain, log-prob and blob rows of the next ``k`` kept steps,
        as views the sampler writes each kept step into directly (blobs
        None for a blob-less store); they count as stored once
        :meth:`commit` is called.  ``dtype`` is the chain's and
        ``lp_dtype`` the log-prob's (``dtype`` by default); each blob
        leaf keeps its template's dtype."""
        need = self.iteration + int(k)
        if self.chain is None or need > self.chain.shape[0]:
            cap = max(need, self._size)
            self.chain = self._grown(
                self.chain, (cap, self.nwalkers, self.ndim), device, dtype
            )
            self.log_prob = self._grown(
                self.log_prob, (cap, self.nwalkers), device,
                lp_dtype or dtype
            )
            if self._blob_template is not None:
                treedef, specs = self._blob_template
                old = (tree_leaves(self.blobs) if self.blobs is not None
                       else [None] * len(specs))
                self.blobs = tree_unflatten(treedef, [
                    self._grown(o, (cap,) + shape, device, dt)
                    for o, (shape, dt) in zip(old, specs)])
        i = self.iteration
        blobs = (None if self.blobs is None
                 else tree_map(lambda b: b[i:need], self.blobs))
        return self.chain[i:need], self.log_prob[i:need], blobs

    def commit(self, accepted, random_state):
        """Count the ``k`` reserved rows as stored; ``accepted`` is the
        ``(k, nwalkers)`` acceptance of their proposals, on the device."""
        acc = accepted.sum(dim=0, dtype=torch.int64)
        self._acc_dev = acc if self._acc_dev is None else self._acc_dev + acc
        self.iteration += accepted.shape[0]
        self.random_state = _random_state(random_state)

    def save_chunk(self, coords, log_prob, blobs, accepted, random_state):
        """Append a chunk of kept steps held in tensors (numpy arrays are
        taken onto the device of the stored chain, or the CPU)."""
        _check_blob_consistency(self.iteration, self.has_blobs, blobs)
        dev = (self.chain.device if self.chain is not None
               else coords.device if isinstance(coords, torch.Tensor)
               else torch.device("cpu"))

        def put(x):
            return torch.as_tensor(x, device=dev)

        coords = put(coords)
        if blobs is not None:
            blobs = tree_map(put, blobs)
            self.grow(max(coords.shape[0], self._size - self.iteration),
                      tree_map(lambda b: b[0], blobs))
        log_prob = put(log_prob)
        chain, lp, rows = self.reserve(coords.shape[0], dev, coords.dtype,
                                       log_prob.dtype)
        chain.copy_(coords)
        lp.copy_(log_prob)
        for r, b in zip(tree_leaves(rows), tree_leaves(blobs)):
            r.copy_(b)
        self.commit(put(accepted), random_state)

    def get_value(self, name, flat=False, thin=1, discard=0):
        return tree_map(_to_numpy, self._slice(name, flat, thin, discard))

    def get_last_sample(self) -> State:
        if (not self.initialized) or self.iteration <= 0:
            raise AttributeError(
                "you must run the sampler with 'store == True' before "
                "accessing the results"
            )
        it = self.iteration
        blobs = None
        if self.blobs is not None:
            blobs = tree_map(lambda b: b[it - 1].clone(), self.blobs)
            declared = getattr(self, "blobs_dtype", None)
            if declared is not None and np.dtype(declared).names:
                blobs = _pack_declared_blobs(tree_map(_to_numpy, blobs),
                                             declared)
        return State(
            coords=self.chain[it - 1].clone(),
            log_prob=self.log_prob[it - 1].clone(),
            blobs=blobs,
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
            blobs = (None if self.blobs is None
                     else tree_map(lambda b: _to_numpy(b[sl]), self.blobs))
            backend.save_chunk(
                _to_numpy(self.chain[sl]),
                _to_numpy(self.log_prob[sl]),
                blobs,
                accepted,
                self.random_state,
            )
        return backend
