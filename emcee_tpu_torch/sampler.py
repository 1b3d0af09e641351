"""The ensemble sampler driver.

The counterpart of ``emcee_tpu/sampler.py:112-1432`` (``EnsembleSampler``):
the constructor's arguments, ``compute_log_prob`` with its guards,
``run_mcmc`` (resume, ``thin_by``, ``store``, ``tune``), the ``sample``
generator, ``reset``, the getters, the deprecated v2 properties and
pickling.  Arguments of the JAX sampler that are not ported yet raise
``NotImplementedError`` naming their ROADMAP item.

Where the JAX package compiles a chunk of kept steps into one
``lax.scan`` (``sampler.py:783-925``), the port runs the chunk through
K3, :class:`~.chunk_graph.ChunkProgram`: on a CUDA device every proposal
(per split, K1, the user's log-prob and K2) runs inside a replayed CUDA
graph; on the CPU the same per-proposal function runs eagerly.  Nothing
waits for the device: the Philox offset advances on the device inside
the graphs and as a host integer beside them, the weighted move choice
is computed on the host from the same stream, acceptance counts add up
on the device (in K2), and with ``store=True`` each kept step is one
slice copy per field (coords, log-prob, acceptance and every blob leaf)
after the replay that ends it: into a :class:`~.backends.DeviceBackend`'s
own rows, or into a device staging buffer that reaches a host
:class:`~.backends.Backend` with one device-to-host copy per chunk.  With
``io_dtype`` the stored coords and float blob leaves are cast on the card
before that copy; the live state stays float32.

Blobs (``emcee_tpu/sampler.py:321-374``, ``:569-603``): the log-prob may
return them after the log-prob (``model.py``); the chunk program keeps one
device buffer per leaf, K2 selects each leaf's rows with the
coordinates', and the backends store each leaf in its dtype.
``blobs_dtype`` names them (``get_blobs`` then returns a structured
array) and, as in the JAX package, turns off the reference layout
(stacking of uniform tuples, squeezing of size-1 axes).

Storage overlaps compute, as the JAX run loop does
(``emcee_tpu/sampler.py:1349-1419``): chunk k's rows go into one of two
pinned host buffers by an asynchronous copy that records a CUDA event;
chunk k+1's replays are enqueued; only then does the host wait on chunk
k's event and write its rows into the backend, while the card computes
chunk k+1.  Each chunk carries its resume anchors (the state, the move
carries and the ``(seed, offset)`` after it, as device clones), and the
anchors move only together with the chunk's save, under
:func:`~.utils.defer_interrupts`: a Ctrl-C never leaves the backend
ahead of the anchors, and ``run_mcmc(None, n)`` after an interrupt
continues the chain exactly.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import moves as _moves_mod
from .backends import Backend
from .chunk_graph import ChunkProgram, blob_signature, clone_carry
from .driver import (
    chunk_replays, chunk_schedule, grow_blobs_template, move_sequence,
    parse_io_dtype, parse_moves, shim_thin, stored_dtype, torch_dtype)
from .model import Model, wrap_log_prob_fn
from .state import State, as_state, resolve_device, walkers_independent
from .utils import (
    defer_interrupts, tree_flatten, tree_leaves, tree_map, tree_unflatten)

__all__ = ["EnsembleSampler", "PRNG_IMPLS", "RunStats", "check_prng"]

#: constructor arguments of the JAX sampler that this slice does not
#: port: name -> (default, ROADMAP item)
_NOT_PORTED = {
    "pool": (None, "P12"),
    "mesh": (None, "P13"),
    "param_axis": (None, "P13"),
    "host_callback": (False, "P12"),
    "host_callback_blobs": (None, "P12"),
}

#: the ``prng`` values the JAX sampler takes (the key implementations of
#: ``jax.random.key``'s ``impl=``, ``None`` the default); the port keeps
#: its one stream, Philox4x32-10, for each
PRNG_IMPLS = (None, "threefry2x32", "rbg", "unsafe_rbg")

#: ``_blob_signature`` before the log-prob was first evaluated
_UNKNOWN = object()

#: deprecated v2 arguments that warn and are ignored (reference
#: ensemble.py:93-113); ``postargs`` is ignored without a warning
_DEPRECATED = ("a", "threads", "runtime_sortingfn", "live_dangerously")


@dataclass
class RunStats:
    """Counters of one ``run_mcmc`` call.  ``walltime_s`` ends with a
    device synchronize; ``accepted`` is the per-walker count over every
    proposal of the run, on the device."""

    nsteps: int = 0
    nproposals: int = 0
    nwalkers: int = 0
    walltime_s: float = 0.0
    accepted: Optional[torch.Tensor] = None
    #: the wall time covers the device's work: it always ends in a
    #: synchronize, so ``run_mcmc(accurate_timing=)`` changes nothing
    accurate: bool = True

    @property
    def walker_steps_per_sec(self) -> float:
        if not self.walltime_s:
            return 0.0
        return self.nproposals * self.nwalkers / self.walltime_s

    @property
    def acceptance_fraction(self):
        """Per-walker acceptance over every proposal of the run."""
        return self.accepted.cpu().numpy() / float(self.nproposals)


class _Chunk(NamedTuple):
    """A chunk whose proposals are enqueued, waiting for its save: its
    rows (:meth:`EnsembleSampler._chunk_rows`, or None unstored), the
    host copy of a host backend's rows (pinned, on the card) and the
    event that ends that copy, and the resume anchors after the chunk.
    ``rows`` is ``(coords, log_prob, accepted, blob rows)``, the last a
    pytree or None; ``host`` the same flattened."""

    rows: Optional[tuple]
    host: Optional[tuple]
    copied: Optional[torch.cuda.Event]
    state: State
    carries: tuple


class EnsembleSampler:
    """An ensemble MCMC sampler on one CUDA device (or the CPU).

    Args:
        nwalkers: number of walkers.
        ndim: parameter-space dimensionality.
        log_prob_fn: log posterior density.  With ``vectorize=False``
            (default) it maps one ``(ndim,)`` tensor and is lifted with
            ``torch.func.vmap``; with ``vectorize=True`` it maps the
            ``(n, ndim)`` batch.
        moves: a move, a list of moves, or a weighted
            ``[(move, weight), ...]`` list.
        args, kwargs: extra arguments passed to ``log_prob_fn``.
        backend: a chain store; defaults to the host :class:`Backend`.
        vectorize: see ``log_prob_fn``.
        blobs_dtype: optional numpy dtype (or list of ``(name, dtype)``)
            applied when fetching blobs: with named fields ``get_blobs``
            returns a structured array, fields in the blobs' leaf order
            (dict blobs by sorted key).
        parameter_names: list of names or dict name -> index / index
            list; the log-prob then receives a dict (reference
            ``ensemble.py:174-214``; not with ``vectorize=True``).
        seed: int seed of the sampler's Philox stream (used when an
            initial state carries no ``random_state``).
        prng: the JAX sampler's key implementation for an int seed
            (``None``, ``"threefry2x32"``, ``"rbg"`` or ``"unsafe_rbg"``);
            taken for drop-in code, and the stream stays Philox4x32-10.
            Any other value raises ``ValueError``, as ``jax.random.key``
            does.
        walker_axis: the mesh axis of the walkers; meaningless until
            ``mesh=`` is ported (ROADMAP P13).
        io_chunk_bytes: bytes of one chunk's storage buffer, which sets
            the kept steps per chunk of a stored run.
        scan_unroll: accepted and unused: the port has no scan, and K3's
            graphs already hold up to ``MAX_GRAPH`` proposals unrolled.
        mixture_block: with several moves, draw the move once per block
            of this many kept steps instead of once per proposal.
        io_dtype: optional float dtype (float16, float32 or float64) of
            the *stored* coords and float blob leaves, cast on the card
            before they leave it; the live state and the log-prob stay
            float32.  Pair with ``Backend(dtype=...)`` to keep the host
            copy compact too.
        max_chunk_steps: optional cap on kept steps per chunk.
        a, threads, live_dangerously, runtime_sortingfn: deprecated v2
            arguments: they warn and are ignored.  ``postargs`` is
            ignored without a warning.
        device: where the walkers live; ``None`` means ``"cuda"``, and
            there is no silent fallback to the CPU.
    """

    def __init__(
        self,
        nwalkers,
        ndim,
        log_prob_fn,
        pool=None,
        moves=None,
        args=None,
        kwargs=None,
        backend=None,
        vectorize=False,
        blobs_dtype=None,
        parameter_names=None,
        seed=0,
        prng=None,
        mesh=None,
        walker_axis="walkers",
        param_axis=None,
        host_callback=False,
        io_chunk_bytes=1 << 27,
        scan_unroll=4,
        mixture_block=1,
        io_dtype=None,
        host_callback_blobs=None,
        max_chunk_steps=None,
        a=None,
        postargs=None,
        threads=None,
        live_dangerously=None,
        runtime_sortingfn=None,
        device=None,
    ):
        check_prng(prng)
        self.prng = prng
        given = dict(
            pool=pool, mesh=mesh, param_axis=param_axis,
            host_callback=host_callback,
            host_callback_blobs=host_callback_blobs,
        )
        for name, (default, item) in _NOT_PORTED.items():
            if given[name] != default:
                raise NotImplementedError(
                    f"EnsembleSampler({name}=...) is not ported yet "
                    f"(ROADMAP {item})"
                )
        deprecated = dict(a=a, threads=threads, live_dangerously=
                          live_dangerously, runtime_sortingfn=
                          runtime_sortingfn)
        for name in _DEPRECATED:
            if deprecated[name] is not None:
                warnings.warn(
                    f"The '{name}' argument is deprecated"
                    + (", use 'moves' instead" if name == "a" else ""),
                    DeprecationWarning, stacklevel=2,
                )
        self.walker_axis = walker_axis
        self._io_chunk_bytes = int(io_chunk_bytes)
        if self._io_chunk_bytes < 1:
            raise ValueError("io_chunk_bytes must be >= 1")
        self.device = resolve_device(device)
        self.dtype = torch.float32
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        self._moves, self._weights = parse_moves(
            moves, _moves_mod.StretchMove
        )
        self.backend = Backend() if backend is None else backend
        self.blobs_dtype = blobs_dtype
        if blobs_dtype is not None:
            # Backends that name blob fields (HDFBackend) or pack declared
            # records (get_last_sample) read the declaration from here.
            self.backend.blobs_dtype = blobs_dtype
        self._io_dtype = parse_io_dtype(io_dtype)
        self.params_are_named = parameter_names is not None
        self.parameter_names = (
            None if parameter_names is None
            else _check_parameter_names(parameter_names, self.ndim,
                                        vectorize))
        if not isinstance(seed, (int, np.integer)):
            raise TypeError("seed must be an int")
        self._rng = (int(seed) & 0xFFFFFFFFFFFFFFFF, 0)
        self._max_chunk_steps = (
            None if max_chunk_steps is None else int(max_chunk_steps)
        )
        if self._max_chunk_steps is not None and self._max_chunk_steps < 1:
            raise ValueError("max_chunk_steps must be >= 1")
        # mixture_block > 1: draw the move once per block of that many
        # kept steps instead of once per proposal (JAX sampler.py:
        # 291-298); a chunk whose length is not a block multiple (e.g.
        # the generator's one-step chunks) falls back to one draw per
        # proposal.
        self._mixture_block = int(mixture_block)
        if self._mixture_block < 1:
            raise ValueError("mixture_block must be >= 1")

        self.log_prob_fn = log_prob_fn
        # The wrapped log-prob and the model are rebuilt from these after
        # unpickling (__setstate__).
        self._lp_settings = dict(
            args=args, kwargs=kwargs, vectorize=vectorize,
            parameter_names=self.parameter_names,
            # Without a declared blobs_dtype, blobs follow the reference's
            # array layout (emcee_tpu/sampler.py:369-374).
            reference_blob_layout=blobs_dtype is None)
        self._build_model()
        # The blobs' structure, shapes and dtypes, known once the log-prob
        # has run (_prepare_state).
        self._blob_signature = _UNKNOWN

        # Resume from a non-empty backend (reference ensemble.py:139-162).
        self._previous_state = None
        self._move_carries = None
        self.last_run_stats = None
        # K3 (chunk_graph.py): the workspace and recorded graphs of the
        # chain's seed, made at the first run.  _use_graphs is the
        # private switch to the eager loop on the card, the reference
        # that tests and chip_smoke.py hold the graphs against.
        self._program = None
        self._use_graphs = self.device.type == "cuda"
        # Two pinned host buffers per chunk shape, used in turns
        # (_stage_rows).
        self._pinned = {}
        if self.backend.initialized:
            if self.backend.shape != (self.nwalkers, self.ndim):
                raise ValueError(
                    "the shape of the backend is incompatible with the "
                    f"shape of the sampler; expected "
                    f"{(self.nwalkers, self.ndim)}, got {self.backend.shape}"
                )
            if self.backend.iteration > 0:
                self._previous_state = self.backend.get_last_sample()
        else:
            self.backend.reset(self.nwalkers, self.ndim)

    def _build_model(self):
        self._compute_log_prob = wrap_log_prob_fn(self.log_prob_fn,
                                                  **self._lp_settings)
        self._model = Model(
            compute_log_prob=self._compute_log_prob,
            nwalkers=self.nwalkers,
            ndim=self.ndim,
        )

    def __getstate__(self):
        # The chunk program (its CUDA graphs), the pinned buffers and the
        # wrapped log-prob do not pickle; they are rebuilt after
        # unpickling (the JAX sampler drops its jitted runners the same
        # way, emcee_tpu/sampler.py:435-451).
        d = self.__dict__.copy()
        d.update(_program=None, _pinned={}, _compute_log_prob=None,
                 _model=None)
        del d["_blob_signature"]
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._build_model()
        self._blob_signature = _UNKNOWN

    # ------------------------------------------------------------------
    # Introspection (reference ensemble.py:555-623)
    # ------------------------------------------------------------------
    @property
    def iteration(self):
        return self.backend.iteration

    @property
    def acceptance_fraction(self):
        """Per-walker fraction of accepted saved-step proposals."""
        return self.backend.accepted / float(self.backend.iteration)

    @property
    def random_state(self):
        """The ``(seed, offset)`` the next proposal draws from."""
        if (
            self._previous_state is not None
            and self._previous_state.random_state is not None
        ):
            return self._previous_state.random_state
        return self._rng

    @random_state.setter
    def random_state(self, rs):
        self._rng = (int(rs[0]), int(rs[1]))
        if self._previous_state is not None:
            self._previous_state = self._previous_state._replace(
                random_state=self._rng
            )

    def _deprecated(self, instead):
        warnings.warn(
            f"this attribute is deprecated; use '{instead}' instead "
            "(reference ensemble.py:560-595 keeps the same shims)",
            DeprecationWarning, stacklevel=3,
        )

    @property
    def chain(self):
        """Deprecated v2 layout ``(nwalkers, steps, ndim)``."""
        self._deprecated("get_chain()")
        return np.swapaxes(self.get_chain(), 0, 1)

    @property
    def flatchain(self):
        self._deprecated("get_chain(flat=True)")
        return self.get_chain(flat=True)

    @property
    def lnprobability(self):
        self._deprecated("get_log_prob()")
        return np.swapaxes(self.get_log_prob(), 0, 1)

    @property
    def flatlnprobability(self):
        self._deprecated("get_log_prob(flat=True)")
        return self.get_log_prob(flat=True)

    @property
    def blobs(self):
        self._deprecated("get_blobs()")
        return self.get_blobs()

    @property
    def flatblobs(self):
        self._deprecated("get_blobs(flat=True)")
        return self.get_blobs(flat=True)

    @property
    def acor(self):
        self._deprecated("get_autocorr_time()")
        return self.get_autocorr_time()

    def get_chain(self, **kwargs):
        return self.get_value("chain", **kwargs)

    def get_log_prob(self, **kwargs):
        return self.get_value("log_prob", **kwargs)

    def get_blobs(self, **kwargs):
        """The stored blobs; with a declared ``blobs_dtype`` of named
        fields, a structured array whose fields take the blob leaves in
        order (``emcee_tpu/sampler.py:569-603``)."""
        if self.blobs_dtype is None:
            return self.get_value("blobs", **kwargs)
        flat = kwargs.pop("flat", False)
        blobs = self.get_value("blobs", **kwargs)
        if blobs is None:
            return None
        if isinstance(blobs, np.ndarray) and blobs.dtype.names is not None:
            out = blobs  # an HDF file stores structured records already
        else:
            declared = np.dtype(self.blobs_dtype)
            leaves = [np.asarray(x) for x in tree_leaves(blobs)]
            if declared.names is None:
                # An unnamed dtype casts the leaves (the reference's
                # np.array(blobs, dtype=blobs_dtype); the JAX package
                # raises TypeError here).
                out = [b.astype(declared) for b in leaves]
                if flat:
                    out = [b.reshape((-1,) + b.shape[2:]) for b in out]
                return out[0] if len(out) == 1 else tuple(out)
            if len(leaves) != len(declared.names):
                raise ValueError(
                    f"blobs_dtype declares {len(declared.names)} fields but "
                    f"the log-prob returns {len(leaves)} blobs"
                )
            dtype = np.dtype([(name, declared[name].base, leaf.shape[2:])
                              for name, leaf in zip(declared.names, leaves)])
            out = np.empty(leaves[0].shape[:2], dtype=dtype)
            for name, leaf in zip(declared.names, leaves):
                out[name] = leaf
        if flat:
            return out.reshape((-1,) + out.shape[2:])
        return out

    def get_value(self, name, **kwargs):
        return self.backend.get_value(name, **kwargs)

    def get_last_sample(self):
        return self.backend.get_last_sample()

    def get_autocorr_time(self, **kwargs):
        return self.backend.get_autocorr_time(**kwargs)

    def reset(self):
        """Clear the backend chain; move carries and the resume anchor
        are kept (reference ``ensemble.py:244-249``)."""
        self.backend.reset(self.nwalkers, self.ndim)

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------
    def _to_device(self, x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(
            np.asarray(x, dtype=np.float64), dtype=self.dtype,
            device=self.device,
        )

    def compute_log_prob(self, coords):
        """Evaluate the batched log-prob with the reference's NaN/inf
        guards (``ensemble.py:458-551``).  Returns ``(log_prob, blobs)``,
        the blobs a pytree of ``(nwalkers, ...)`` tensors or None."""
        p = self._to_device(coords)
        if bool(torch.isinf(p).any()):
            raise ValueError("At least one parameter value was infinite")
        if bool(torch.isnan(p).any()):
            raise ValueError("At least one parameter value was NaN")
        log_prob, blobs = self._evaluate(p)
        if bool(torch.isnan(log_prob).any()):
            raise ValueError("Probability function returned NaN")
        return log_prob, blobs

    def _evaluate(self, p):
        """The log-prob and blobs at device coords ``p``, noting the
        blobs' signature."""
        log_prob, blobs = self._compute_log_prob(p)
        self._blob_signature = blob_signature(blobs)
        return log_prob, blobs

    def _blobs_to_device(self, blobs, coords):
        """A given state's blobs as device tensors in the structure and
        dtypes the log-prob returns (evaluated once at ``coords`` if it has
        not run yet).  A state with blobs whose log-prob returns none, or
        other leaves, raises."""
        if self._blob_signature is _UNKNOWN:
            self._evaluate(coords)
        sig = self._blob_signature
        if sig is None:
            raise ValueError(
                "inconsistent use of blobs: the resumed state carries blobs "
                "but the log-prob returns none"
            )
        leaves = tree_leaves(blobs)
        out = []
        if len(leaves) == len(sig[1]):
            for leaf, (shape, dt) in zip(leaves, sig[1]):
                t = (leaf.detach() if isinstance(leaf, torch.Tensor)
                     else torch.as_tensor(np.asarray(leaf)))
                if tuple(t.shape) != shape:
                    break
                out.append(t.to(device=self.device, dtype=dt))
        if len(out) != len(sig[1]):
            raise ValueError(
                "inconsistent use of blobs: the state's blobs do not match "
                "the leaves the log-prob returns"
            )
        # In the log-prob's structure: a file keeps a nested blob's leaves
        # flat, in the same leaf order.
        return tree_unflatten(sig[0], out)

    def _prepare_state(self, initial_state, skip_initial_state_check,
                       trusted=False):
        """The checked initial state on the device (the chunk program
        copies it into its workspace, so the caller's tensors are never
        written).  ``trusted``: the sampler's own resume anchor, whose
        checks already passed."""
        state = as_state(initial_state)
        log_prob, blobs = state.log_prob, state.blobs
        io = self._io_dtype
        if (io is not None and io.itemsize < 4
                and _torch_dtype_or_none(
                    getattr(state.coords, "dtype", None)) == io):
            # Resuming from a store of reduced precision: sample in
            # float32 and recompute the log-prob and blobs, which belong
            # to the unrounded coords (emcee_tpu/sampler.py:1001-1022).
            log_prob = blobs = None
        if isinstance(blobs, np.ndarray) and (
                blobs.dtype.names is not None or blobs.dtype == object):
            # A backend's declared record row: recompute from the coords.
            blobs = None
        coords = self._to_device(state.coords)
        if tuple(coords.shape) != (self.nwalkers, self.ndim):
            raise ValueError(
                f"incompatible input dimensions {tuple(coords.shape)}"
            )
        if (
            not trusted
            and not skip_initial_state_check
            and not walkers_independent(coords)
        ):
            raise ValueError(
                "Initial state has a large condition number. "
                "Make sure that your walkers are linearly independent for "
                "the best performance"
            )
        rs = state.random_state
        rs = self._rng if rs is None else (int(rs[0]), int(rs[1]))
        if log_prob is None:
            return State(coords, *self.compute_log_prob(coords), rs)
        log_prob = self._to_device(log_prob)
        if tuple(log_prob.shape) != (self.nwalkers,):
            raise ValueError("incompatible input dimensions")
        if not trusted and bool(torch.isnan(log_prob).any()):
            raise ValueError("The initial log_prob was NaN")
        if blobs is not None:
            blobs = self._blobs_to_device(blobs, coords)
        else:
            if self._blob_signature is _UNKNOWN:
                self._evaluate(coords)
            if self._blob_signature is not None:
                # The log-prob returns blobs the state lacks: evaluate
                # both (the JAX sampler's blob probe, sampler.py:1080).
                log_prob, blobs = self.compute_log_prob(coords)
        return State(coords, log_prob, blobs, rs)

    # ------------------------------------------------------------------
    # The run loop
    # ------------------------------------------------------------------
    def _init_carries(self):
        return tuple(
            m.init_carry(self.nwalkers, self.ndim, device=self.device)
            for m in self._moves
        )

    def _auto_chunk(self, store, blobs=None):
        """Kept steps per chunk: the storage buffer stays under
        ``io_chunk_bytes``; the caps follow the JAX sampler."""
        if self._max_chunk_steps is not None:
            cap = self._max_chunk_steps
        elif not store or getattr(self.backend, "wants_device_arrays", False):
            cap = 16384
        else:
            cap = 4096
        if store:
            coords_dt, lp_dt = self._row_dtypes()
            row = self.nwalkers * (self.ndim * coords_dt.itemsize
                                   + lp_dt.itemsize + 1)
            for b in tree_leaves(blobs):
                row += b.numel() * stored_dtype(b.dtype,
                                                self._io_dtype).itemsize
            cap = min(cap, max(1, self._io_chunk_bytes // row))
        return cap

    def _chunk_schedule(self, nsteps, max_chunk):
        blk = self._mixture_block if len(self._moves) > 1 else 1
        return chunk_schedule(nsteps, max_chunk, blk)

    def _row_dtypes(self):
        """The torch dtypes of a chunk's stored coords and log-prob rows:
        the walkers' own for a device backend, else the host backend's
        (float64 unless the backend was made with another ``dtype``);
        coords in ``io_dtype`` when it is set."""
        if getattr(self.backend, "wants_device_arrays", False):
            dt = self.dtype
        else:
            chain = getattr(self.backend, "chain", None)
            dt = _torch_dtype_or_none(np.dtype(
                (getattr(self.backend, "dtype", None) or np.float64)
                if chain is None else chain.dtype)) or torch.float64
        return self._io_dtype or dt, dt

    def _chunk_rows(self, nkeep, blobs):
        """Where a chunk's kept steps go: ``(coords, log_prob, accepted,
        blob rows)`` of shapes ``(nkeep, nwalkers, ndim)``, ``(nkeep,
        nwalkers)``, ``(nkeep, nwalkers)`` and ``(nkeep, nwalkers, ...)``
        per blob leaf (None without blobs), each kept step copied in after
        the replay that ends it.  A device-resident backend hands out its
        own rows, so each kept step is written once.  For a host backend
        they are device staging buffers: coords in the backend's dtype (or
        ``io_dtype``) and the log-prob in the backend's, so the float32 to
        float64 conversion (exact) or the cast to ``io_dtype`` runs on the
        card and the host's write is a plain copy of contiguous rows
        (reference ``ensemble.py:409-417``); blob leaves in their stored
        dtypes."""
        nw, nd, dev = self.nwalkers, self.ndim, self.device
        accepted = torch.empty((nkeep, nw), dtype=torch.bool, device=dev)
        coords_dt, lp_dt = self._row_dtypes()
        if getattr(self.backend, "wants_device_arrays", False):
            coords, log_prob, rows = self.backend.reserve(nkeep, dev,
                                                          coords_dt, lp_dt)
            return coords, log_prob, accepted, rows
        rows = tree_map(lambda b: torch.empty(
            (nkeep,) + tuple(b.shape),
            dtype=stored_dtype(b.dtype, self._io_dtype), device=dev), blobs)
        return (torch.empty((nkeep, nw, nd), dtype=coords_dt, device=dev),
                torch.empty((nkeep, nw), dtype=lp_dt, device=dev), accepted,
                rows)

    def _stage_rows(self, rows):
        """Start the copy of a chunk's staging buffers (a flat tuple of
        tensors) to the host: into
        the next of two sets of pinned buffers, asynchronously, with an
        event that marks its end.  Returns ``(host rows, event)``; on the
        CPU the buffers are host rows already.  A set holds the largest
        chunk yet (pinned memory is slow to allocate, so it is kept for
        the sampler's life and a smaller chunk takes a view)."""
        if self.device.type != "cuda":
            return rows, None
        k = rows[0].shape[0]
        key = tuple((tuple(r.shape[1:]), r.dtype) for r in rows)
        sets = self._pinned.get(key)
        if sets is None or sets[0][0].shape[0] < k:
            sets = self._pinned[key] = [
                tuple(torch.empty((k,) + r.shape[1:], dtype=r.dtype,
                                  pin_memory=True) for r in rows)
                for _ in range(2)
            ]
        host = tuple(h[:k] for h in sets[0])
        sets.reverse()
        for h, r in zip(host, rows):
            h.copy_(r, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(self.device))
        return host, copied

    def _start(self, state, carries):
        """The chunk program of ``state``'s seed, loaded with the state and
        the carries; a program recorded for another seed is dropped."""
        seed, offset = state.random_state
        prog = self._program
        if (prog is None or prog.seed != seed
                or prog.blob_signature != blob_signature(state.blobs)):
            prog = self._program = ChunkProgram(
                self._moves, self._model, seed, state.coords, state.log_prob,
                carries, state.blobs,
            )
        prog.load(state.coords, state.log_prob, offset, carries, state.blobs)
        return prog, offset

    def _enqueue(self, prog, offset, nkeep, thin_by, store, tune):
        """Enqueue one chunk of ``nkeep * thin_by`` proposals from
        ``offset`` through the chunk program, its kept rows and (for a
        host backend) their copy to the host, and snapshot the resume
        anchors after it.  Nothing waits for the device.  Returns the
        :class:`_Chunk`, which :meth:`_commit` saves."""
        ws = prog.ws
        out = self._chunk_rows(nkeep, ws.blobs) if store else None
        seq = move_sequence(self._weights, prog.seed, offset, nkeep, thin_by,
                            self._mixture_block)
        done = 0
        for i, n in chunk_replays(seq, thin_by if store else None):
            prog.run(i, n, tune, self._use_graphs)
            done += n
            if store and done % thin_by == 0:
                k = done // thin_by - 1
                out[0][k].copy_(ws.coords)
                out[1][k].copy_(ws.log_prob)
                out[2][k].copy_(ws.accepted)
                for rows, b in zip(tree_leaves(out[3]),
                                   tree_leaves(ws.blobs)):
                    rows[k].copy_(b)
        host = copied = None
        if store and not getattr(self.backend, "wants_device_arrays",
                                 False):
            host, copied = self._stage_rows(
                out[:3] + tuple(tree_leaves(out[3])))
        rs = (prog.seed, offset + nkeep * thin_by)
        return _Chunk(
            out, host, copied,
            State(ws.coords.clone(), ws.log_prob.clone(),
                  tree_map(torch.clone, ws.blobs), rs),
            tuple(clone_carry(c) for c in ws.carries),
        )

    def _commit(self, chunk):
        """Save a chunk (waiting for its copy to the host, if any) and
        move the resume anchors to it, with SIGINT held between the two,
        so the anchors always match what the backend holds."""
        with defer_interrupts():
            rs = chunk.state.random_state
            if chunk.rows is not None and chunk.host is None:
                self.backend.commit(chunk.rows[2], rs)
            elif chunk.rows is not None:
                if chunk.copied is not None:
                    chunk.copied.synchronize()
                coords, log_prob, accepted, *leaves = (
                    h.numpy() for h in chunk.host)
                blobs = (None if chunk.rows[3] is None else tree_unflatten(
                    tree_flatten(chunk.rows[3])[1], leaves))
                self.backend.save_chunk(coords, log_prob, blobs, accepted,
                                        rs)
            self._previous_state = chunk.state
            self._move_carries = chunk.carries
            self._rng = rs

    @staticmethod
    def _check_progress(progress):
        if progress:
            raise NotImplementedError(
                "progress bars are not ported yet (ROADMAP P12)"
            )

    def sample(
        self,
        initial_state,
        iterations=1,
        tune=False,
        skip_initial_state_check=False,
        thin_by=1,
        store=True,
        progress=False,
        progress_kwargs=None,
        thin=None,
    ):
        """Advance the chain as a generator, yielding the state after
        every ``thin_by`` proposals (reference ``ensemble.py:258-424``);
        ``iterations=None`` streams forever and needs ``store=False``."""
        self._check_progress(progress)
        if iterations is None and store:
            raise ValueError("'store' must be False when 'iterations' is None")
        if thin is not None:
            iterations, thin_by = shim_thin(iterations, thin)
        thin_by = int(thin_by)
        if thin_by <= 0:
            raise ValueError("Invalid thinning argument")

        state = self._prepare_state(initial_state, skip_initial_state_check)
        prog, offset = self._start(
            state, self._move_carries or self._init_carries())
        if store:
            self.backend.grow(iterations, grow_blobs_template(
                state.blobs, self._io_dtype))
        i = 0
        while iterations is None or i < iterations:
            chunk = self._enqueue(prog, offset, 1, thin_by, store, tune)
            self._commit(chunk)
            offset = chunk.state.random_state[1]
            i += 1
            yield self._previous_state

    def run_mcmc(self, initial_state, nsteps, **kwargs):
        """Run ``nsteps`` kept steps and return the final :class:`State`.

        ``initial_state=None`` continues from the previous run (reference
        ``ensemble.py:441-447``).  ``nsteps == 0`` returns None and clears
        the resume anchor (``ensemble.py:449-456``).
        """
        trusted = False
        if initial_state is None:
            if self._previous_state is None:
                raise ValueError(
                    "Cannot have `initial_state=None` if run_mcmc has never "
                    "been called."
                )
            initial_state = self._previous_state
            trusted = True

        tune = kwargs.pop("tune", False)
        thin_by = int(kwargs.pop("thin_by", 1))
        thin = kwargs.pop("thin", None)
        if thin is not None:
            nsteps, thin_by = shim_thin(nsteps, thin)
        store = kwargs.pop("store", True)
        self._check_progress(kwargs.pop("progress", False))
        kwargs.pop("progress_kwargs", None)
        skip_check = kwargs.pop("skip_initial_state_check", False)
        # Accepted for the JAX signature: the wall time below always ends
        # in a synchronize.
        kwargs.pop("accurate_timing", False)
        if kwargs:
            raise TypeError(f"unexpected keyword arguments: {list(kwargs)}")
        if thin_by <= 0:
            raise ValueError("Invalid thinning argument")
        nsteps = int(nsteps)

        state = self._prepare_state(initial_state, skip_check, trusted=trusted)
        if nsteps == 0:
            self._previous_state = None
            return None
        prog, offset = self._start(
            state, self._move_carries or self._init_carries())
        prog.ws.count.zero_()
        if store:
            self.backend.grow(nsteps, grow_blobs_template(
                state.blobs, self._io_dtype))
        t0 = time.perf_counter()
        # Chunk k is saved after chunk k+1 is enqueued, so the host's
        # write of k overlaps the card's compute of k+1.  A device
        # backend and an unstored run have nothing to wait for: they
        # commit at once.  The finally saves the pending chunk whatever
        # stops the loop (an interrupt or a failure of a later chunk);
        # it is taken off ``pending`` before its save, so an interrupt
        # raised at the end of the save cannot save it twice.
        pending = None
        try:
            for n in self._chunk_schedule(
                    nsteps, self._auto_chunk(store, state.blobs)):
                chunk = self._enqueue(prog, offset, n, thin_by, store, tune)
                offset = chunk.state.random_state[1]
                if pending is not None:
                    done, pending = pending, None
                    self._commit(done)
                if chunk.host is None:
                    self._commit(chunk)
                else:
                    pending = chunk
        finally:
            if pending is not None:
                done, pending = pending, None
                self._commit(done)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_run_stats = RunStats(
            nsteps=nsteps,
            nproposals=nsteps * thin_by,
            nwalkers=self.nwalkers,
            walltime_s=time.perf_counter() - t0,
            accepted=prog.ws.count.clone(),
        )
        return self._previous_state


def check_prng(prng):
    """Refuse a ``prng`` that ``jax.random.key(seed, impl=prng)`` refuses
    (a value outside :data:`PRNG_IMPLS`)."""
    if prng not in PRNG_IMPLS:
        raise ValueError(
            f"unknown PRNG implementation {prng!r}; the JAX sampler takes "
            f"one of {PRNG_IMPLS[1:]} (the port draws from Philox4x32-10 "
            "for each)"
        )


def _check_parameter_names(names, ndim, vectorize):
    """The canonical ``{name: index or index list}`` of ``parameter_names``
    with the JAX sampler's checks (``emcee_tpu/sampler.py:321-357``,
    reference ``ensemble.py:174-214``), raised as ``AssertionError`` as
    there (and kept under ``python -O``)."""

    def check(cond, msg=""):
        if not cond:
            raise AssertionError(msg)

    check(isinstance(names, (list, dict)))
    check(not vectorize,
          "named parameters with vectorization unsupported for now")
    seen = set()
    uniq = [n for n in names if not (n in seen or seen.add(n))]
    check(len(uniq) == len(names), f"duplicate parameters: {seen}")
    if isinstance(names, list):
        check(len(names) == ndim,
              "name all parameters or set `parameter_names` to `None`")
        names = {name: i for i, name in enumerate(names)}
    check(len(names) <= ndim, "too many names")
    flat = set()
    for v in names.values():
        flat.update(v if isinstance(v, list) else [v])
    check(flat == set(range(ndim)),
          f"not all values appear -- set should be 0 to {ndim - 1}")
    return names


def _torch_dtype_or_none(dt):
    """The torch dtype of numpy or torch dtype ``dt``; None for None or
    a dtype torch has not (numpy's longdouble)."""
    if dt is None:
        return None
    try:
        return torch_dtype(dt)
    except TypeError:
        return None
