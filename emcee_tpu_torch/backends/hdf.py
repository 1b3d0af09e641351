"""HDF5 chain backend, in the on-disk schema of the JAX package and the
reference.

The counterpart of ``emcee_tpu/backends/hdf.py:55-75`` and ``:209-677``
(``does_hdf5_support_longdouble``, ``HDFBackend``, ``TempHDFBackend``):
a named group holding the attrs ``version``, ``nwalkers``, ``ndim``,
``has_blobs`` and ``iteration`` and the resizable datasets ``accepted``,
``chain``, ``log_prob`` (and ``blobs`` when present), so a file written
by either package, or by the reference, reads in the others.  Writes land
per chunk (one file transaction per :meth:`HDFBackend.save_chunk`).

Blobs are one ``blobs`` dataset of shape ``(iteration, nwalkers)``: a
lone leaf keeps its plain dtype (the reference's single-blob layout);
several leaves become one structured record with a field per leaf, named
by the sampler's ``blobs_dtype``, else by the dict keys, else
``blob{i}``, in the leaf order of :func:`~..utils.tree_leaves` (dict
keys sorted).  The ``blobs_kind`` (``leaf``, ``tuple``, ``dict`` or
``other``) and ``blobs_fields`` attrs rebuild the pytree on resume.

The random state: the port writes its Philox ``(seed, offset)`` as the
attr ``torch_random_state``, the JAX package its key data as
``jax_random_state``; each package reads only its own.  A port resuming
a file without ``torch_random_state`` (written by the JAX package or the
reference) sees ``random_state`` None, so its sampler starts the stream
from its own ``seed`` at offset 0, as the JAX package does with a file
it did not write.

Not ported: ``shard_per_process`` and ``merge_shards`` (multi-process
storage, ROADMAP P13).  ``h5py`` is imported when a backend is made, and
its absence raises ``ImportError`` there.
"""

from __future__ import annotations

import os

import numpy as np

from ..state import State
from ..utils import tree_leaves, tree_map
from .backend import Backend, _check_blob_consistency, _to_numpy

__all__ = ["HDFBackend", "TempHDFBackend", "does_hdf5_support_longdouble"]

#: the attr of the port's Philox ``(seed, offset)``
RANDOM_STATE_ATTR = "torch_random_state"


def _h5py():
    try:
        import h5py
    except ImportError as err:
        raise ImportError("you must install 'h5py' to use the HDFBackend"
                          ) from err
    return h5py


def does_hdf5_support_longdouble():
    """Whether this platform's HDF5 round-trips ``np.longdouble``
    (reference ``backends/hdf.py:22-38``)."""
    try:
        h5py = _h5py()
    except ImportError:
        return False
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".h5", prefix="emcee-torch-ldprobe")
    os.close(fd)
    try:
        probe = np.arange(2, dtype=np.longdouble)
        with h5py.File(path, "w") as f:
            f.create_dataset("probe", data=probe)
        with h5py.File(path, "r") as f:
            back = f["probe"][...]
        return back.dtype == np.longdouble
    finally:
        os.remove(path)


def _flatten_blobs(blobs):
    """A blob pytree as ``(leaves, kind, names)``: ``kind`` is ``"leaf"``
    (one array), ``"tuple"`` (a flat sequence), ``"dict"`` (a flat
    mapping; ``names`` its sorted keys) or ``"other"`` (nested: stored
    flat, rebuilt as a tuple)."""
    if isinstance(blobs, dict):
        names = sorted(blobs)
        vals = [blobs[k] for k in names]
        if all(not isinstance(v, (dict, tuple, list)) for v in vals):
            return [_to_numpy(v) for v in vals], "dict", list(names)
    if isinstance(blobs, (tuple, list)):
        if all(not isinstance(v, (dict, tuple, list)) for v in blobs):
            return [_to_numpy(v) for v in blobs], "tuple", None
    leaves = [_to_numpy(x) for x in tree_leaves(blobs)]
    if len(leaves) == 1 and not isinstance(blobs, (dict, tuple, list)):
        return leaves, "leaf", None
    return leaves, "other", None


def _blob_record_dtype(leaves, names, declared=None):
    """One field per leaf, the leaf's row shape its sub-shape; base dtypes
    from the ``declared`` blobs_dtype when given, else the leaves'."""
    fields = []
    for i, (name, leaf) in enumerate(zip(names, leaves)):
        base = leaf.dtype
        if declared is not None and declared.names is not None:
            base = declared[declared.names[i]].base
        fields.append((name, base, leaf.shape[1:]))
    return np.dtype(fields)


def _pack_records(leaves, names, lead_ndim):
    """The leaves as one structured array over their ``lead_ndim`` leading
    axes."""
    lead = leaves[0].shape[:lead_ndim]
    dtype = np.dtype([(name, leaf.dtype, leaf.shape[lead_ndim:])
                      for name, leaf in zip(names, leaves)])
    out = np.empty(lead, dtype=dtype)
    for name, leaf in zip(names, leaves):
        out[name] = leaf
    return out


def _unpack_records(row, kind, names):
    """The stored pytree kind rebuilt from one structured record row."""
    if kind == "dict":
        return {n: np.asarray(row[n]) for n in names}
    return tuple(np.asarray(row[n]) for n in names)


def _check_blob_fields(stored_names, stored_kind, leaves, kind, names):
    """Refuse blobs that no longer match the file's layout: the leaf
    count, a dict against a tuple (sorted keys against positions), and a
    dict's keys."""
    if len(stored_names) != len(leaves):
        raise ValueError(
            "blob structure changed: file stores "
            f"{len(stored_names)} fields, got {len(leaves)} leaves"
        )
    if "dict" in (stored_kind, kind) and stored_kind != kind:
        raise ValueError(
            "blob structure changed: file stores kind "
            f"'{stored_kind}', got '{kind}'"
        )
    if kind == "dict" and list(names) != list(stored_names):
        raise ValueError(
            "blob field names changed: file stores "
            f"{list(stored_names)}, got {list(names)}"
        )


def _random_state_attr(rs):
    """The port's ``(seed, offset)`` as the file's uint64 pair."""
    return np.array([int(rs[0]) & 0xFFFFFFFFFFFFFFFF, int(rs[1])],
                    dtype=np.uint64)


class HDFBackend(Backend):
    """A backend that stores the chain in an HDF5 file.

    Args:
        filename: path of the HDF5 file.
        name: group name holding this run (several named runs per file,
            reference ``hdf.py:60``).
        read_only: refuse write access when True.
        dtype: the stored chain's dtype (float64 by default; an existing
            run's is adopted).
        compression / compression_opts: passed to dataset creation.
        shard_per_process: not ported (ROADMAP P13).
    """

    #: optional [(name, dtype), ...] declaration naming the blob fields
    #: on disk; the sampler forwards its ``blobs_dtype`` argument here.
    blobs_dtype = None

    def __init__(self, filename, name="mcmc", read_only=False, dtype=None,
                 compression=None, compression_opts=None,
                 shard_per_process=False):
        _h5py()
        if shard_per_process:
            raise NotImplementedError(
                "HDFBackend(shard_per_process=True) is not ported yet "
                "(ROADMAP P13)"
            )
        self.filename = filename
        self.name = name
        self.read_only = read_only
        self.compression = compression
        self.compression_opts = compression_opts
        self.dtype_set = dtype is not None
        self.dtype = np.float64 if dtype is None else dtype

    @property
    def initialized(self):
        if not os.path.exists(self.filename):
            return False
        try:
            with self.open() as f:
                return self.name in f
        except OSError:
            return False

    def open(self, mode="r"):
        if mode != "r" and self.read_only:
            raise RuntimeError(
                "The backend has been loaded in read-only "
                "mode. Set `read_only = False` to make "
                "changes."
            )
        f = _h5py().File(self.filename, mode)
        # Adopt an existing run's chain dtype, so appends keep it.
        if not self.dtype_set:
            run = f.get(self.name)
            if run is not None and "chain" in run:
                self.dtype = run["chain"].dtype
                self.dtype_set = True
        return f

    def _dataset_opts(self):
        return dict(compression=self.compression,
                    compression_opts=self.compression_opts)

    def reset(self, nwalkers, ndim):
        """Drop any existing run group and lay out an empty one."""
        nw, nd = int(nwalkers), int(ndim)
        with self.open("a") as f:
            if self.name in f:
                del f[self.name]
            g = f.create_group(self.name)
            g.attrs.update({"version": "tpu-0", "nwalkers": nw, "ndim": nd,
                            "has_blobs": False, "iteration": 0})
            g.create_dataset("accepted", data=np.zeros(nw),
                             **self._dataset_opts())
            for dsname, tail in (("chain", (nw, nd)), ("log_prob", (nw,))):
                g.create_dataset(dsname, shape=(0,) + tail,
                                 maxshape=(None,) + tail, dtype=self.dtype,
                                 **self._dataset_opts())

    def _read_attr(self, key):
        with self.open() as f:
            return f[self.name].attrs[key]

    @property
    def nwalkers(self):
        return int(self._read_attr("nwalkers"))

    @property
    def ndim(self):
        return int(self._read_attr("ndim"))

    @property
    def iteration(self):
        return int(self._read_attr("iteration"))

    @property
    def has_blobs(self):
        return bool(self._read_attr("has_blobs"))

    @property
    def accepted(self):
        with self.open() as f:
            return np.asarray(f[self.name]["accepted"])

    @property
    def random_state(self):
        """The port's ``(seed, offset)``, or None in a file the port did
        not write."""
        with self.open() as f:
            data = f[self.name].attrs.get(RANDOM_STATE_ATTR)
        return None if data is None else (int(data[0]), int(data[1]))

    @property
    def shape(self):
        with self.open() as f:
            g = f[self.name]
            return (int(g.attrs["nwalkers"]), int(g.attrs["ndim"]))

    def _blob_field_names(self, leaves, names):
        """Field names: the declared blobs_dtype's, then dict keys, then
        ``blob{i}``."""
        if self.blobs_dtype is not None:
            declared = np.dtype(self.blobs_dtype).names
            if declared is not None and len(declared) == len(leaves):
                return list(declared)
        if names is not None:
            return names
        return [f"blob{i}" for i in range(len(leaves))]

    def grow(self, ngrow, blobs):
        """Extend capacity by ``ngrow`` steps; ``blobs`` is an example
        per-walker blob pytree (leaves ``(nwalkers, ...)``) that lays out
        the blob storage the first time blobs appear."""
        with self.open("a") as f:
            g = f[self.name]
            it = int(g.attrs["iteration"])
            _check_blob_consistency(it, g.attrs["has_blobs"], blobs)
            ntot = it + int(ngrow)
            g["chain"].resize(ntot, axis=0)
            g["log_prob"].resize(ntot, axis=0)
            if blobs is None:
                return
            if g.attrs["has_blobs"]:
                g["blobs"].resize(ntot, axis=0)
                return
            leaves, kind, names = _flatten_blobs(blobs)
            names = self._blob_field_names(leaves, names)
            nw = int(g.attrs["nwalkers"])
            if any(leaf.ndim == 0 or leaf.shape[0] != nw for leaf in leaves):
                raise ValueError(
                    "blob example passed to grow() must have leading "
                    f"nwalkers={nw} axis; got shapes "
                    f"{[leaf.shape for leaf in leaves]}"
                )
            declared = None
            if self.blobs_dtype is not None:
                d = np.dtype(self.blobs_dtype)
                if d.names is not None and len(d.names) == len(leaves):
                    declared = d
            if kind == "leaf":
                dt = np.dtype((leaves[0].dtype, leaves[0].shape[1:]))
            else:
                dt = _blob_record_dtype(leaves, names, declared)
            g.create_dataset("blobs", shape=(ntot, nw), maxshape=(None, nw),
                             dtype=dt, **self._dataset_opts())
            g.attrs["has_blobs"] = True
            g.attrs["blobs_kind"] = kind
            g.attrs["blobs_fields"] = names

    def _blobs_to_rows(self, g, blobs):
        """A chunk's blob pytree as the ``(k, nwalkers)`` rows of the
        dataset."""
        leaves, kind, new_names = _flatten_blobs(blobs)
        stored_kind = g.attrs.get("blobs_kind", "leaf")
        if stored_kind == "leaf":
            return leaves[0]
        names = list(g.attrs["blobs_fields"])
        _check_blob_fields(names, stored_kind, leaves, kind, new_names)
        return _pack_records(leaves, names, lead_ndim=2)

    def save_chunk(self, coords, log_prob, blobs, accepted, random_state):
        """Append a chunk of kept steps (see :meth:`Backend.save_chunk`);
        the port's ``(seed, offset)`` goes to ``torch_random_state``."""
        coords = _to_numpy(coords)
        k = coords.shape[0]
        with self.open() as f:
            g = f[self.name]
            it = int(g.attrs["iteration"])
            _check_blob_consistency(it, g.attrs["has_blobs"], blobs)
            short = it + k - g["chain"].shape[0]
            need_blob_init = blobs is not None and not g.attrs["has_blobs"]
        if short > 0 or need_blob_init:
            example = (None if blobs is None
                       else tree_map(lambda b: _to_numpy(b)[0], blobs))
            self.grow(max(short, 0), example)
        with self.open("a") as f:
            g = f[self.name]
            g["chain"][it : it + k] = coords
            g["log_prob"][it : it + k] = _to_numpy(log_prob)
            if blobs is not None:
                g["blobs"][it : it + k] = self._blobs_to_rows(g, blobs)
            g["accepted"][...] = (np.asarray(g["accepted"])
                                  + _to_numpy(accepted).sum(axis=0))
            if random_state is not None:
                g.attrs[RANDOM_STATE_ATTR] = _random_state_attr(
                    random_state)
            g.attrs["iteration"] = it + k

    def get_value(self, name, flat=False, thin=1, discard=0):
        if not self.initialized:
            raise AttributeError(
                "You must run the sampler with 'store == True' before "
                "accessing the results"
            )
        with self.open() as f:
            g = f[self.name]
            iteration = int(g.attrs["iteration"])
            if iteration <= 0:
                raise AttributeError(
                    "you must run the sampler with 'store == True' before "
                    "accessing the results"
                )
            if name == "blobs" and not g.attrs["has_blobs"]:
                return None
            if name not in ("chain", "log_prob", "blobs"):
                raise ValueError(f"unrecognized value name: {name}")
            v = g[name][discard + thin - 1 : iteration : thin]
            if flat:
                v = v.reshape((-1,) + v.shape[2:])
            return v

    def _slice(self, name, flat=False, thin=1, discard=0):
        return self.get_value(name, flat, thin, discard)

    def get_last_sample(self) -> State:
        if not self.initialized:
            raise AttributeError(
                "you must run the sampler with 'store == True' before "
                "accessing the results"
            )
        it = self.iteration
        if it <= 0:
            raise AttributeError(
                "you must run the sampler with 'store == True' before "
                "accessing the results"
            )
        with self.open() as f:
            g = f[self.name]
            blobs = None
            if g.attrs["has_blobs"]:
                row = g["blobs"][it - 1]
                declared = self.blobs_dtype
                kind = g.attrs.get("blobs_kind", "leaf")
                if (row.dtype.names is not None and not (
                        declared is not None and np.dtype(declared).names)
                        and kind != "leaf"):
                    blobs = _unpack_records(row, kind,
                                            list(g.attrs["blobs_fields"]))
                else:
                    # A lone leaf, or declared named blobs: the reference
                    # carries the structured record row on the state.
                    blobs = np.asarray(row)
            return State(
                coords=np.asarray(g["chain"][it - 1]),
                log_prob=np.asarray(g["log_prob"][it - 1]),
                blobs=blobs,
                random_state=self.random_state,
            )


class TempHDFBackend:
    """Context manager making a disposable HDF backend (for tests)."""

    def __init__(self, dtype=None, compression=None, compression_opts=None):
        self.dtype = dtype
        self.filename = None
        self.compression = compression
        self.compression_opts = compression_opts

    def __enter__(self):
        import tempfile

        f = tempfile.NamedTemporaryFile(
            prefix="emcee-temporary-hdf5", suffix=".hdf5", delete=False
        )
        f.close()
        self.filename = f.name
        return HDFBackend(f.name, "test", dtype=self.dtype,
                          compression=self.compression,
                          compression_opts=self.compression_opts)

    def __exit__(self, exception_type, exception_value, traceback):
        os.remove(self.filename)
