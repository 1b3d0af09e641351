"""The ensemble sampler driver.

The counterpart of ``emcee_tpu/sampler.py:112-1432`` (``EnsembleSampler``)
for the subset this slice ports: the constructor's core arguments,
``compute_log_prob`` with its guards, ``run_mcmc`` (resume, ``thin_by``,
``store``, ``tune``), the ``sample`` generator, ``reset`` and the
getters.  Arguments of the JAX sampler that are not ported yet raise
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
slice copy per field after the replay that ends it: into a
:class:`~.backends.DeviceBackend`'s own chain rows, or into a device
staging buffer that reaches a host :class:`~.backends.Backend` with one
device-to-host copy per chunk.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import moves as _moves_mod
from .backends import Backend
from .chunk_graph import ChunkProgram
from .driver import (
    chunk_replays, chunk_schedule, move_sequence, parse_moves, shim_thin)
from .model import Model, wrap_log_prob_fn
from .state import State, as_state, resolve_device, walkers_independent

__all__ = ["EnsembleSampler", "RunStats"]

#: constructor arguments of the JAX sampler that this slice does not
#: port: name -> (default, ROADMAP item)
_NOT_PORTED = {
    "pool": (None, "P12"),
    "blobs_dtype": (None, "P10"),
    "parameter_names": (None, "P1"),
    "prng": (None, "P3: the port has one generator, Philox4x32-10"),
    "mesh": (None, "P13"),
    "param_axis": (None, "P13"),
    "host_callback": (False, "P12"),
    "io_dtype": (None, "P10"),
}

#: bytes of one chunk's device staging buffer (as io_chunk_bytes in the
#: JAX sampler)
_CHUNK_BYTES = 1 << 27


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

    @property
    def walker_steps_per_sec(self) -> float:
        if not self.walltime_s:
            return 0.0
        return self.nproposals * self.nwalkers / self.walltime_s

    @property
    def acceptance_fraction(self):
        """Per-walker acceptance over every proposal of the run."""
        return self.accepted.cpu().numpy() / float(self.nproposals)


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
        seed: int seed of the sampler's Philox stream (used when an
            initial state carries no ``random_state``).
        mixture_block: with several moves, draw the move once per block
            of this many kept steps instead of once per proposal.
        max_chunk_steps: optional cap on kept steps per chunk.
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
        param_axis=None,
        host_callback=False,
        io_dtype=None,
        mixture_block=1,
        max_chunk_steps=None,
        device=None,
    ):
        given = dict(
            pool=pool, blobs_dtype=blobs_dtype,
            parameter_names=parameter_names, prng=prng, mesh=mesh,
            param_axis=param_axis, host_callback=host_callback,
            io_dtype=io_dtype,
        )
        for name, (default, item) in _NOT_PORTED.items():
            if given[name] != default:
                raise NotImplementedError(
                    f"EnsembleSampler({name}=...) is not ported yet "
                    f"(ROADMAP {item})"
                )
        self.device = resolve_device(device)
        self.dtype = torch.float32
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        self._moves, self._weights = parse_moves(
            moves, _moves_mod.StretchMove
        )
        self.backend = Backend() if backend is None else backend
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
        self._compute_log_prob = wrap_log_prob_fn(
            log_prob_fn, args=args, kwargs=kwargs, vectorize=vectorize
        )
        self._model = Model(
            compute_log_prob=self._compute_log_prob,
            nwalkers=self.nwalkers,
            ndim=self.ndim,
        )

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

    def get_chain(self, **kwargs):
        return self.get_value("chain", **kwargs)

    def get_log_prob(self, **kwargs):
        return self.get_value("log_prob", **kwargs)

    def get_blobs(self, **kwargs):
        return self.get_value("blobs", **kwargs)

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
        guards (``ensemble.py:458-551``).  Returns ``(log_prob, None)``."""
        p = self._to_device(coords)
        if bool(torch.isinf(p).any()):
            raise ValueError("At least one parameter value was infinite")
        if bool(torch.isnan(p).any()):
            raise ValueError("At least one parameter value was NaN")
        log_prob, blobs = self._compute_log_prob(p)
        if bool(torch.isnan(log_prob).any()):
            raise ValueError("Probability function returned NaN")
        return log_prob, blobs

    def _prepare_state(self, initial_state, skip_initial_state_check,
                       trusted=False):
        """The checked initial state on the device (the chunk program
        copies it into its workspace, so the caller's tensors are never
        written).  ``trusted``: the sampler's own resume anchor, whose
        checks already passed."""
        state = as_state(initial_state)
        if state.blobs is not None:
            raise NotImplementedError(
                "states with blobs are not ported yet (ROADMAP P10)"
            )
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
        if state.log_prob is None:
            log_prob, _ = self.compute_log_prob(coords)
        else:
            log_prob = self._to_device(state.log_prob)
            if tuple(log_prob.shape) != (self.nwalkers,):
                raise ValueError("incompatible input dimensions")
            if not trusted and bool(torch.isnan(log_prob).any()):
                raise ValueError("The initial log_prob was NaN")
        return State(coords, log_prob, None, rs)

    # ------------------------------------------------------------------
    # The run loop
    # ------------------------------------------------------------------
    def _init_carries(self):
        return tuple(
            m.init_carry(self.nwalkers, self.ndim, device=self.device)
            for m in self._moves
        )

    def _auto_chunk(self, store):
        """Kept steps per chunk: the storage buffer stays under
        ``_CHUNK_BYTES``; the caps follow the JAX sampler."""
        if self._max_chunk_steps is not None:
            cap = self._max_chunk_steps
        elif not store or getattr(self.backend, "wants_device_arrays", False):
            cap = 16384
        else:
            cap = 4096
        if store:
            row = self.nwalkers * (self.ndim + 2) * 4
            cap = min(cap, max(1, _CHUNK_BYTES // row))
        return cap

    def _chunk_schedule(self, nsteps, max_chunk):
        blk = self._mixture_block if len(self._moves) > 1 else 1
        return chunk_schedule(nsteps, max_chunk, blk)

    def _chunk_rows(self, nkeep):
        """Where a chunk's kept steps go: ``(coords, log_prob, accepted)``
        of shapes ``(nkeep, nwalkers, ndim)``, ``(nkeep, nwalkers)`` and
        ``(nkeep, nwalkers)``, plus the host staging buffer or None.  A
        device-resident backend hands out its own chain rows, so each
        kept step is written once; otherwise the three share one
        ``(nkeep, nwalkers, ndim + 2)`` buffer, which reaches the host
        with one copy (reference ``ensemble.py:409-417``)."""
        nd = self.ndim
        if getattr(self.backend, "wants_device_arrays", False):
            coords, log_prob = self.backend.reserve(
                nkeep, self.device, self.dtype
            )
            accepted = torch.empty(
                (nkeep, self.nwalkers), dtype=torch.bool, device=self.device
            )
            return coords, log_prob, accepted, None
        rows = torch.empty(
            (nkeep, self.nwalkers, nd + 2), dtype=self.dtype,
            device=self.device,
        )
        return rows[..., :nd], rows[..., nd], rows[..., nd + 1], rows

    def _start(self, state, carries):
        """The chunk program of ``state``'s seed, loaded with the state and
        the carries; a program recorded for another seed is dropped."""
        seed, offset = state.random_state
        prog = self._program
        if prog is None or prog.seed != seed:
            prog = self._program = ChunkProgram(
                self._moves, self._model, seed, state.coords, state.log_prob,
                carries,
            )
        prog.load(state.coords, state.log_prob, offset, carries)
        self._move_carries = prog.ws.carries
        return prog, offset

    def _save_chunk(self, out, random_state):
        coords, log_prob, accepted, rows = out
        if rows is None:
            self.backend.commit(accepted, random_state)
            return
        nd = self.ndim
        rows = rows.cpu().numpy()
        self.backend.save_chunk(
            rows[..., :nd], rows[..., nd], None, rows[..., nd + 1] != 0,
            random_state,
        )

    def _advance(self, prog, offset, nkeep, thin_by, store, tune):
        """Run one chunk of ``nkeep * thin_by`` proposals from ``offset``
        through the chunk program, store it, and move the resume anchors
        to a snapshot of its final state, so the anchors always match what
        the backend holds.  Returns the next offset."""
        ws = prog.ws
        out = self._chunk_rows(nkeep) if store else None
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
        offset += nkeep * thin_by
        rs = (prog.seed, offset)
        if store:
            self._save_chunk(out, rs)
        self._previous_state = State(ws.coords.clone(), ws.log_prob.clone(),
                                     None, rs)
        self._rng = rs
        return offset

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
            self.backend.grow(iterations, None)
        i = 0
        while iterations is None or i < iterations:
            offset = self._advance(prog, offset, 1, thin_by, store, tune)
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
            self.backend.grow(nsteps, None)
        t0 = time.perf_counter()
        for n in self._chunk_schedule(nsteps, self._auto_chunk(store)):
            offset = self._advance(prog, offset, n, thin_by, store, tune)
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
