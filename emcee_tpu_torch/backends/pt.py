"""Backends for parallel-tempered chains.

The counterpart of ``emcee_tpu/backends/pt.py``: the chain-store contract
on the ``(ntemps, nwalkers)`` ladder.  The chain is ``(it, T, nwalkers,
ndim)``, with per-rung ``log_like`` and ``log_prior`` ``(it, T,
nwalkers)``, the user blobs of the likelihood (a pytree of ``(it, T,
nwalkers, ...)`` leaves, each in its own dtype), the cumulative
``accepted`` counts ``(T, nwalkers)``, the pair-swap counters
``swaps_accepted`` and ``swaps_proposed`` ``(T - 1,)`` (one entry with one
rung), the ladder ``betas`` and the random state, so a tempered run
resumes as a flat one does.  ``random_state`` is the port's ``(seed,
offset)`` pair.

:class:`PTBackend` keeps the chain in host numpy arrays;
:class:`PTDeviceBackend` keeps it in device memory (the sampler writes
each kept step into its rows, and acceptance adds up on the device), and
``get_*`` return numpy copies of the rows asked for; ``to_host`` drains it
into a host backend.  :class:`PTHDFBackend` keeps it in an HDF5 group of
the JAX package's schema (``emcee_tpu/backends/pt.py:390-679``): attrs
``version``, ``ntemps``, ``nwalkers``, ``ndim``, ``iteration`` and
``has_blobs``, datasets ``chain``, ``log_like``, ``log_prior``,
``accepted``, ``swaps_accepted``, ``swaps_proposed`` and ``betas``, and
the blobs as one record dataset ``(it, T, nwalkers)`` with a field per
leaf (``blob{i}`` or the dict's keys; attrs ``blobs_kind`` and
``blobs_fields``), so a file written by either package reads in the
other.  The port writes its random state as the attr
``torch_random_state`` (the JAX package its key as
``jax_random_state``); each package reads only its own.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..driver import torch_dtype
from ..utils import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .backend import _check_blob_consistency, _random_state, _to_numpy
from .hdf import (
    RANDOM_STATE_ATTR, _check_blob_fields, _flatten_blobs, _h5py,
    _pack_records, _random_state_attr, _unpack_records)

__all__ = ["PTBackend", "PTDeviceBackend", "PTHDFBackend"]


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
        self.blobs = None
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
        return self.blobs is not None

    def grow(self, ngrow, blobs=None):
        """Pre-allocate room for ``ngrow`` more kept steps; ``blobs`` is a
        kept step's blob template (leaves ``(T, nwalkers, ...)`` in the
        dtypes to store) that lays out the blob storage the first time."""
        _check_blob_consistency(self.iteration, self.has_blobs, blobs)
        blobs = tree_map(_to_numpy, blobs)
        new_size = self.iteration + int(ngrow)
        if self.chain is not None and new_size <= self._size:
            # Already pre-sized, but a first blob template still allocates.
            if blobs is not None and self.blobs is None:
                self.blobs = tree_map(lambda b: np.empty(
                    (self._size,) + b.shape, dtype=b.dtype), blobs)
            return
        self._size = new_size

        def grown(arr, shape, dt):
            new = np.empty((self._size,) + tuple(shape), dtype=dt)
            if arr is not None:
                new[: self.iteration] = arr[: self.iteration]
            return new

        T, nw, nd = self.ntemps, self.nwalkers, self.ndim
        self.chain = grown(self.chain, (T, nw, nd), self.dtype)
        self.log_like = grown(self.log_like, (T, nw), self.dtype)
        self.log_prior = grown(self.log_prior, (T, nw), self.dtype)
        if self.blobs is not None:
            self.blobs = tree_map(
                lambda old: grown(old, old.shape[1:], old.dtype), self.blobs)
        elif blobs is not None:
            self.blobs = tree_map(lambda b: grown(None, b.shape, b.dtype),
                                  blobs)

    def save_chunk(self, coords, log_like, log_prior, accepted,
                   swaps_accepted, swaps_proposed, random_state, betas,
                   blobs=None):
        """Append a chunk of kept steps: ``coords`` ``(k, T, nwalkers,
        ndim)``, ``log_like``/``log_prior``/``accepted`` ``(k, T,
        nwalkers)``, the blobs' leaves ``(k, T, nwalkers, ...)``; the swap
        counters and ladder after it."""
        coords = _to_numpy(coords)
        k = coords.shape[0]
        _check_blob_consistency(self.iteration, self.has_blobs, blobs)
        if self.chain is None or self.iteration + k > self._size:
            # Un-pre-grown: grow geometrically (amortised O(n) copying).
            self.grow(max(k, self.iteration), None if blobs is None else
                      tree_map(lambda b: _to_numpy(b)[0], blobs))
        elif blobs is not None and self.blobs is None:
            self.grow(k, tree_map(lambda b: _to_numpy(b)[0], blobs))
        i = self.iteration
        self.chain[i: i + k] = coords
        self.log_like[i: i + k] = _to_numpy(log_like)
        self.log_prior[i: i + k] = _to_numpy(log_prior)
        for dst, src in zip(tree_leaves(self.blobs), tree_leaves(blobs)):
            dst[i: i + k] = _to_numpy(src)
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
        """The stored blob pytree, leaves ``(it, T, nwalkers, ...)`` (one
        rung's with ``temp``), or None without blobs."""
        if not self.has_blobs:
            return None
        if self.iteration <= 0:
            raise AttributeError(
                "you must run the sampler with 'store == True' before "
                "accessing the results"
            )

        def sl(leaf):
            v = _to_numpy(leaf[discard + thin - 1: self.iteration: thin])
            return v[:, temp] if temp is not None else v

        return tree_map(sl, self.blobs)

    def _row(self, name):
        return getattr(self, name)[self.iteration - 1]

    def get_last_sample(self):
        from ..parallel.tempering import PTState

        if self.iteration <= 0:
            raise AttributeError("empty backend")
        blobs = (None if self.blobs is None
                 else tree_map(lambda b: b[self.iteration - 1], self.blobs))
        return PTState(coords=self._row("chain"),
                       log_like=self._row("log_like"),
                       log_prior=self._row("log_prior"),
                       random_state=self.random_state, blobs=blobs)


class PTDeviceBackend(PTBackend):
    """Device-resident store for parallel-tempered chains (the tempered
    counterpart of :class:`~.device.DeviceBackend`): the sampler writes
    each kept step into the chain's device rows, acceptance adds up on
    the device, and only the ``(T - 1,)`` swap counters cross to the
    host, once a chunk."""

    #: sampler hint: hand out device rows, not host copies
    wants_device_arrays = True

    def reset(self, ntemps, nwalkers, ndim):
        super().reset(ntemps, nwalkers, ndim)
        self._acc_dev = None
        self._blob_template = None

    @property
    def has_blobs(self):
        return self.blobs is not None or self._blob_template is not None

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
        """Record the capacity a run needs and, the first time blobs
        appear, their template (the leaves' shapes and stored dtypes); the
        tensors are allocated on the chunk's device at the next
        :meth:`reserve`."""
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

    def reserve(self, k, device, dtype=torch.float32, lp_dtype=None):
        """The chain, ``log_like``, ``log_prior`` and blob rows of the next
        ``k`` kept steps, as views the sampler writes each kept step into
        (blobs None for a blob-less store); they count as stored at
        :meth:`commit`.  ``dtype`` is the chain's and ``lp_dtype`` the
        log-values' (``dtype`` by default); each blob leaf keeps its
        template's dtype."""
        need = self.iteration + int(k)
        if self.chain is None or need > self.chain.shape[0]:
            cap = max(need, self._size)
            T, nw, nd = self.shape
            lp_dtype = lp_dtype or dtype
            self.chain = self._grown(self.chain, (cap, T, nw, nd), device,
                                     dtype)
            self.log_like = self._grown(self.log_like, (cap, T, nw), device,
                                        lp_dtype)
            self.log_prior = self._grown(self.log_prior, (cap, T, nw),
                                         device, lp_dtype)
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
        return (self.chain[i:need], self.log_like[i:need],
                self.log_prior[i:need], blobs)

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
        log_like = put(log_like)
        *rows, blob_rows = self.reserve(coords.shape[0], dev, coords.dtype,
                                        log_like.dtype)
        for dst, src in zip(rows, (coords, log_like, log_prior)):
            dst.copy_(put(src))
        for dst, src in zip(tree_leaves(blob_rows), tree_leaves(blobs)):
            dst.copy_(src)
        self.commit(put(accepted), swaps_accepted, swaps_proposed,
                    random_state, betas)

    def get_last_sample(self):
        from ..parallel.tempering import PTState

        it = self.iteration
        if it <= 0:
            raise AttributeError("empty backend")
        blobs = (None if self.blobs is None
                 else tree_map(lambda b: b[it - 1].clone(), self.blobs))
        return PTState(coords=self.chain[it - 1].clone(),
                       log_like=self.log_like[it - 1].clone(),
                       log_prior=self.log_prior[it - 1].clone(),
                       random_state=self.random_state, blobs=blobs)

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
            blobs = (None if self.blobs is None
                     else tree_map(lambda b: _to_numpy(b[sl]), self.blobs))
            backend.save_chunk(
                _to_numpy(self.chain[sl]), _to_numpy(self.log_like[sl]),
                _to_numpy(self.log_prior[sl]),
                (self.accepted - backend.accepted)[None],
                self.swaps_accepted, self.swaps_proposed,
                self.random_state, self.betas, blobs=blobs,
            )
        return backend


class PTHDFBackend(PTBackend):
    """HDF5 store for parallel-tempered chains, in the JAX package's
    group schema (see the module docstring); writes land per chunk, one
    file transaction per :meth:`save_chunk`.

    Args:
        filename: path of the HDF5 file.
        name: group name holding this run.
        read_only: refuse write access when True.
        dtype: the stored chain's and log-values' dtype (float64 by
            default).
    """

    def __init__(self, filename, name="ptmcmc", read_only=False, dtype=None):
        _h5py()
        self.filename = filename
        self.name = name
        self.read_only = read_only
        self.dtype = dtype or np.float64

    @property
    def initialized(self):
        if not os.path.exists(self.filename):
            return False
        try:
            with _h5py().File(self.filename, "r") as f:
                return self.name in f
        except OSError:
            return False

    def open(self, mode="r"):
        if self.read_only and mode != "r":
            raise RuntimeError("backend loaded in read-only mode")
        return _h5py().File(self.filename, mode)

    def reset(self, ntemps, nwalkers, ndim):
        T, nw, nd = int(ntemps), int(nwalkers), int(ndim)
        with self.open("a") as f:
            if self.name in f:
                del f[self.name]
            g = f.create_group(self.name)
            g.attrs.update({"version": "tpu-0", "ntemps": T, "nwalkers": nw,
                            "ndim": nd, "iteration": 0, "has_blobs": False})
            g.create_dataset("accepted", data=np.zeros((T, nw)))
            for name in ("swaps_accepted", "swaps_proposed"):
                g.create_dataset(name, data=np.zeros(max(T - 1, 1)))
            g.create_dataset("betas", data=np.zeros(T))
            for name, shape in (("chain", (T, nw, nd)), ("log_like", (T, nw)),
                                ("log_prior", (T, nw))):
                g.create_dataset(name, (0,) + shape,
                                 maxshape=(None,) + shape, dtype=self.dtype)

    @staticmethod
    def _ensure_blob_dataset(g, template):
        """Create the record dataset of the blobs from a kept step's
        template (leaves ``(T, nwalkers, ...)``) on first sight."""
        if "blobs" in g:
            return
        leaves, kind, names = _flatten_blobs(template)
        if names is None:
            names = [f"blob{i}" for i in range(len(leaves))]
        dtype = np.dtype([(name, leaf.dtype, leaf.shape[2:])
                          for name, leaf in zip(names, leaves)])
        T, nw = leaves[0].shape[:2]
        g.create_dataset("blobs", (0, T, nw), maxshape=(None, T, nw),
                         dtype=dtype)
        g.attrs["has_blobs"] = True
        g.attrs["blobs_kind"] = kind
        g.attrs["blobs_fields"] = names

    def grow(self, ngrow, blobs=None):
        """Pre-size the datasets (an h5py resize; no data is copied)."""
        with self.open("a") as f:
            g = f[self.name]
            _check_blob_consistency(int(g.attrs["iteration"]),
                                    g.attrs.get("has_blobs", False), blobs)
            if blobs is not None:
                self._ensure_blob_dataset(g, blobs)
            size = int(g.attrs["iteration"]) + int(ngrow)
            for name in ("chain", "log_like", "log_prior", "blobs"):
                if name in g and size > g[name].shape[0]:
                    g[name].resize(size, axis=0)

    def _attr(self, name):
        with self.open() as f:
            return f[self.name].attrs[name]

    def _dataset(self, name):
        with self.open() as f:
            return np.asarray(f[self.name][name])

    @property
    def ntemps(self):
        return int(self._attr("ntemps"))

    @property
    def nwalkers(self):
        return int(self._attr("nwalkers"))

    @property
    def ndim(self):
        return int(self._attr("ndim"))

    @property
    def iteration(self):
        return int(self._attr("iteration"))

    @property
    def has_blobs(self):
        return bool(self._attr("has_blobs"))

    @property
    def accepted(self):
        return self._dataset("accepted")

    @property
    def swaps_accepted(self):
        return self._dataset("swaps_accepted")

    @property
    def swaps_proposed(self):
        return self._dataset("swaps_proposed")

    @property
    def betas(self):
        return self._dataset("betas")

    @property
    def random_state(self):
        """The port's ``(seed, offset)``, or None in a file the port did
        not write."""
        with self.open() as f:
            data = f[self.name].attrs.get(RANDOM_STATE_ATTR)
        return None if data is None else (int(data[0]), int(data[1]))

    def save_chunk(self, coords, log_like, log_prior, accepted,
                   swaps_accepted, swaps_proposed, random_state, betas,
                   blobs=None):
        """Append a chunk of kept steps (see :meth:`PTBackend.save_chunk`);
        a blob structure that differs from the file's raises."""
        coords = _to_numpy(coords)
        k = coords.shape[0]
        with self.open("a") as f:
            g = f[self.name]
            it = int(g.attrs["iteration"])
            _check_blob_consistency(it, g.attrs.get("has_blobs", False),
                                    blobs)
            writes = [("chain", coords), ("log_like", _to_numpy(log_like)),
                      ("log_prior", _to_numpy(log_prior))]
            if blobs is not None:
                self._ensure_blob_dataset(
                    g, tree_map(lambda b: _to_numpy(b)[0], blobs))
                leaves, kind, new_names = _flatten_blobs(blobs)
                names = list(g.attrs["blobs_fields"])
                _check_blob_fields(names, g.attrs.get("blobs_kind", "leaf"),
                                   leaves, kind, new_names)
                writes.append(("blobs", _pack_records(leaves, names,
                                                      lead_ndim=3)))
            for name, val in writes:
                ds = g[name]
                if it + k > ds.shape[0]:
                    ds.resize(it + k, axis=0)
                ds[it: it + k] = val
            g["accepted"][...] = (np.asarray(g["accepted"])
                                  + _to_numpy(accepted).sum(axis=0))
            g["swaps_accepted"][...] = np.asarray(swaps_accepted)
            g["swaps_proposed"][...] = np.asarray(swaps_proposed)
            g["betas"][...] = np.asarray(betas)
            if random_state is not None:
                g.attrs[RANDOM_STATE_ATTR] = _random_state_attr(random_state)
            g.attrs["iteration"] = it + k

    def _get(self, name, discard=0, thin=1):
        with self.open() as f:
            g = f[self.name]
            it = int(g.attrs["iteration"])
            if it <= 0:
                raise AttributeError(
                    "you must run the sampler with 'store == True' before "
                    "accessing the results"
                )
            return np.asarray(g[name][discard + thin - 1: it: thin])

    def get_blobs(self, discard=0, thin=1, temp=None, structured=False):
        """Stored blobs with leading ``(it, T, nwalkers)`` axes (one
        rung's with ``temp``): the pytree the in-memory backends return,
        rebuilt from the record dataset, or that dataset itself with
        ``structured=True``."""
        with self.open() as f:
            g = f[self.name]
            if not g.attrs.get("has_blobs", False):
                return None
            it = int(g.attrs["iteration"])
            if it <= 0:
                raise AttributeError(
                    "you must run the sampler with 'store == True' before "
                    "accessing the results"
                )
            v = np.asarray(g["blobs"][discard + thin - 1: it: thin])
            kind = g.attrs.get("blobs_kind", "leaf")
            names = list(g.attrs["blobs_fields"])
        if structured:
            return v[:, temp] if temp is not None else v
        if kind == "leaf" or v.dtype.names is None:
            out = np.asarray(v[names[0]]) if v.dtype.names else v
            return out[:, temp] if temp is not None else out
        blobs = _unpack_records(v, kind, names)
        if temp is not None:
            blobs = tree_map(lambda b: b[:, temp], blobs)
        return blobs

    def get_last_sample(self):
        from ..parallel.tempering import PTState

        with self.open() as f:
            g = f[self.name]
            it = int(g.attrs["iteration"])
            if it <= 0:
                raise AttributeError("empty backend")
            blobs = None
            if g.attrs.get("has_blobs", False):
                row = g["blobs"][it - 1]
                kind = g.attrs.get("blobs_kind", "leaf")
                names = list(g.attrs["blobs_fields"])
                blobs = (np.asarray(row[names[0]]) if kind == "leaf"
                         else _unpack_records(row, kind, names))
            return PTState(coords=np.asarray(g["chain"][it - 1]),
                           log_like=np.asarray(g["log_like"][it - 1]),
                           log_prior=np.asarray(g["log_prior"][it - 1]),
                           random_state=self.random_state, blobs=blobs)

