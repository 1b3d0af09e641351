"""The parallel-tempered ensemble sampler.

The counterpart of ``emcee_tpu/parallel/tempering.py`` (``PTSampler``,
``PTState``, ``default_beta_ladder``): a ladder of inverse temperatures
``betas``; rung ``t`` samples ``beta_t * log_like + log_prior``; each rung
runs the ensemble move; after every ``swap_every`` proposals adjacent
rungs exchange walkers with probability ``min(1, exp((beta_i - beta_j)
(logL_j - logL_i)))``, pairing even and odd rungs in turn by the step's
parity.

Where the JAX package vmaps one move over the rungs (one fused XLA
program for all of them), the port proposes every rung at once where the
move's kernels take the rung axis (the stretch, DE and DE-snooker moves:
K1, K5a or K5b and K2 launch once a split for all rungs; the MALA, HMC,
ensemble MALA and ensemble HMC moves: K11, K12, K13 and K2 launch once a
step for all rungs; the KDE move: K7 and K2 launch once a split for all
rungs; DIME: K8a, K8b and K8c; DE-Z: K10a, K10b and K10c; the side
move: K5a's side mode; the walk move: K8a, K8b's walk mode and K18a, or
K18b for a subset; the slice move: K9a, K9d and K9c's first list once a
split and K9b or K9c once a loop trip for all rungs, each rung's list in its own rows; the shuffled
split of any of them: K14 draws every rung's sort keys, K16 orders every
rung's walkers in one launch and K17 gathers and scatters every rung's
rows in one launch each way; the tempered log-prob, and its gradient, is
evaluated once over ``T * n`` rows), and otherwise loops over the rungs,
each an ensemble of its own with its own tempered model, carry and
key.  The
swap is K15 (``ops/swap_kernel.py``).  A chunk runs through
:class:`~..chunk_graph.TemperedProgram`: on a CUDA device every proposal
is a replay of its CUDA graphs; on the CPU the same function runs
eagerly.

Each rung draws under a key of its own (``ops/philox.py`` ``rung_seed``:
rung 0's is the chain's seed), so a 1-rung ladder at ``beta = 1`` draws
what an :class:`~..sampler.EnsembleSampler` of the same seed draws.  The
step whose parity pairs the rungs is the chain's proposal counter (its
Philox offset), which continues across runs, stored or not; the JAX
package counts from ``backend.iteration * thin_by`` of a stored run and
from 0 of an unstored one.  The swap counts proposed are computed on the
host from the same steps (:meth:`PTSampler._count_proposed_delta`).

A weighted move list runs as the JAX package's does: one move a proposal
for every rung, or one a block of ``mixture_block`` kept steps, drawn on
the host from the chain's seed (``driver.move_sequence``); the chunk
program runs each stretch of equal moves, every move (the stretch, DE,
DE-snooker, MALA, HMC, ChEES, ensemble MALA, ensemble HMC, KDE, DIME,
DE-Z, side, walk, slice, Gaussian, MH and blended moves) on every rung at
once; only the private ``_batched = False`` switch runs them rung by
rung.  The looped moves run their loops for every rung at once:
``EnsembleSliceMove`` with one read of the lists' lengths a block,
``ChEESHMCMove`` with one read of the largest trip count a proposal,
each rung stepping only while it has trips left.

User blobs of ``log_like_fn`` (the prior's are ignored) ride with the
walkers: K2 selects them with the rows, K15 exchanges them with the
walkers, and the backends store them ``(it, T, nwalkers, ...)``.
``io_dtype`` casts the stored coords and float blob leaves on the card;
``parameter_names`` hands both functions dicts of named parameters.

``adaptive=True`` adapts the ladder after every chunk (Vousden et al.
2016; :meth:`PTSampler._adapt_ladder`, the JAX package's arithmetic on
the host) from the swap counts the run reads anyway; the new ladder is
copied into the chunk program's ``betas`` and the tempered log-prob
formed again, and ``self.betas`` commits with the chunk's save.  Since
the ladder changes at chunk boundaries, the chunk schedule is part of
the result: an adaptive run cuts its chunks where the JAX package cuts
them under its default configuration (float32 walkers, a cap of 4096
kept steps, every stored byte of a kept step counted against
``io_chunk_bytes``; :meth:`PTSampler._max_chunk`), so that the same swap
counts give the same ladder.

Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP item: ``pool``, ``host_callback``, ``host_callback_blobs`` and
progress bars (P12); ``mesh``, ``temp_axis`` and ``param_axis`` (P13).
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .. import moves as _moves_mod
from ..autocorr import integrated_time
from ..backends.pt import PTBackend
from ..chunk_graph import TemperedProgram, blob_signature, clone_carry
from ..driver import (
    chunk_replays, chunk_schedule, grow_blobs_template, move_sequence,
    parse_io_dtype, parse_moves, shim_thin, stored_dtype, torch_dtype)
from ..model import wrap_log_prob_fn
from ..ops.philox import rung_keys
from ..sampler import RunStats, _check_parameter_names, _torch_dtype_or_none
from ..state import resolve_device, walkers_independent
from ..utils import (
    defer_interrupts, tree_leaves, tree_map, tree_unflatten)

__all__ = ["PTSampler", "PTState", "default_beta_ladder"]

#: constructor arguments of the JAX sampler that are not ported yet:
#: name -> (default, ROADMAP item)
_NOT_PORTED = {
    "pool": (None, "P12"),
    "host_callback": (False, "P12"),
    "host_callback_blobs": (None, "P12"),
    "mesh": (None, "P13"),
    "temp_axis": (None, "P13"),
    "param_axis": (None, "P13"),
}


def default_beta_ladder(ntemps, ndim, max_temp=None):
    """Geometric inverse-temperature ladder (``emcee_tpu/parallel/
    tempering.py:59-74``): spacing ``1 + sqrt(2/ndim)`` per rung (Vousden
    et al. 2016); with ``max_temp`` given, geometric over ``[1,
    max_temp]``."""
    if max_temp is None:
        ratio = 1.0 + np.sqrt(2.0 / ndim)
        return ratio ** (-np.arange(ntemps, dtype=np.float64))
    return np.exp(np.linspace(0.0, -np.log(max_temp), ntemps))


#: the likelihood's blob structure before its first evaluation
_UNKNOWN = object()


class PTState(NamedTuple):
    """Snapshot of the tempered ensemble; leading axes ``(ntemps,
    nwalkers)``.  ``random_state`` is the port's ``(seed, offset)``;
    ``blobs`` holds the user blobs of the likelihood (a pytree of ``(T,
    nwalkers, ...)`` leaves), or None."""

    coords: Any  # (T, nw, nd)
    log_like: Any  # (T, nw)
    log_prior: Any  # (T, nw)
    random_state: Optional[tuple] = None
    blobs: Optional[Any] = None

    @property
    def ntemps(self):
        return self.coords.shape[0]

    @property
    def nwalkers(self):
        return self.coords.shape[1]

    @property
    def ndim(self):
        return self.coords.shape[2]


class _Chunk(NamedTuple):
    """A chunk's kept rows (``(coords, log_like, log_prior, accepted,
    blob rows)``, or None unstored), the swap counts and anchors after
    it."""

    rows: Optional[tuple]
    swaps: torch.Tensor
    state: PTState
    carries: tuple
    proposals: int


class PTSampler:
    """Parallel-tempered ensemble sampler on one CUDA device (or the CPU).

    Args:
        ntemps: number of temperature rungs.
        nwalkers: walkers per rung.
        ndim: parameter dimensionality.
        log_like_fn: log likelihood of one ``(ndim,)`` vector (lifted
            with ``torch.func.vmap``), or of an ``(n, ndim)`` batch with
            ``vectorize=True``; ``args`` / ``kwargs`` are passed to it.
            It may return blobs after the value, as the JAX package's
            may; they ride with the walkers.
        log_prior_fn: log prior, same convention (no extra arguments, as
            in the JAX package).
        betas: explicit inverse-temperature ladder (default:
            :func:`default_beta_ladder`).
        moves: a move, a list of moves or a weighted ``[(move, weight),
            ...]`` list (default ``StretchMove()``).
        swap_every: proposals between swap attempts (default 1).
        adaptive: adapt the ladder after every chunk toward equal
            adjacent swap acceptance, ``adaptation_lag`` and
            ``adaptation_time`` setting the decay (Vousden et al. 2016).
        seed: int seed of the Philox stream.
        backend: a :class:`~..backends.PTBackend` (default),
            :class:`~..backends.PTDeviceBackend` or
            :class:`~..backends.PTHDFBackend`.
        io_chunk_bytes: bytes of one chunk's stored rows, which sets the
            kept steps per chunk of a stored run.
        io_dtype: optional float dtype of the stored coords and float
            blob leaves (cast on the card); the log-likelihood and
            log-prior are stored in the backend's dtype.
        parameter_names: a list of names or a dict from names to an index
            or index list: both functions then take a dict of named
            parameters.
        mixture_block: with several moves, draw the move once per block
            of this many kept steps.
        walker_axis, scan_unroll: accepted; meaningful once a mesh and
            the scan are ported.
        device: where the walkers live; ``None`` means ``"cuda"``.
    """

    def __init__(self, ntemps, nwalkers, ndim, log_like_fn, log_prior_fn,
                 betas=None, moves=None, args=None, kwargs=None,
                 vectorize=False, swap_every=1, adaptive=False,
                 adaptation_lag=10_000, adaptation_time=100, seed=0,
                 backend=None, mesh=None, walker_axis="walkers",
                 temp_axis=None, param_axis=None, io_chunk_bytes=1 << 27,
                 scan_unroll=4, io_dtype=None, parameter_names=None,
                 host_callback=False, pool=None, host_callback_blobs=None,
                 mixture_block=1, device=None):
        given = dict(pool=pool, host_callback=host_callback,
                     host_callback_blobs=host_callback_blobs, mesh=mesh,
                     temp_axis=temp_axis, param_axis=param_axis)
        for name, (default, item) in _NOT_PORTED.items():
            if given[name] is not default and given[name] != default:
                raise NotImplementedError(
                    f"PTSampler({name}=...) is not ported yet (ROADMAP "
                    f"{item})"
                )
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        if betas is None:
            betas = default_beta_ladder(ntemps, ndim)
        self.betas = np.asarray(betas, dtype=np.float64)
        self.ntemps = len(self.betas)
        if self.ntemps != int(ntemps):
            raise ValueError(f"betas holds {self.ntemps} rungs, ntemps is "
                             f"{ntemps}")
        self.swap_every = int(swap_every)
        self.adaptive = bool(adaptive)
        self.adaptation_lag = float(adaptation_lag)
        self.adaptation_time = float(adaptation_time)
        self.walker_axis = walker_axis
        self._moves, self._weights = parse_moves(moves,
                                                 _moves_mod.StretchMove)
        self._mixture_block = int(mixture_block)
        if self._mixture_block < 1:
            raise ValueError("mixture_block must be >= 1")
        if not isinstance(seed, (int, np.integer)):
            raise TypeError("seed must be an int")
        self._rng = (int(seed) & 0xFFFFFFFFFFFFFFFF, 0)
        self.device = resolve_device(device)
        self.dtype = torch.float32
        self._io_chunk_bytes = int(io_chunk_bytes)
        if self._io_chunk_bytes < 1:
            raise ValueError("io_chunk_bytes must be >= 1")
        self._io_dtype = parse_io_dtype(io_dtype)
        self.parameter_names = (
            None if parameter_names is None
            else _check_parameter_names(parameter_names, self.ndim,
                                        vectorize))
        self._log_like_fn = log_like_fn
        self._log_prior_fn = log_prior_fn
        # Extra arguments reach the likelihood only, named parameters both
        # functions (the JAX package's _like_settings and _lp_settings).
        self._prior_settings = dict(vectorize=vectorize,
                                    parameter_names=self.parameter_names)
        self._like_settings = dict(args=args, kwargs=kwargs,
                                   **self._prior_settings)
        self._blob_signature = _UNKNOWN
        self._wrap_fns()
        # K3's tempered program (made at the first run); the private
        # switches: _use_graphs (off: the eager loop on the card, the
        # reference) and _batched (off: every move loops over the rungs,
        # the rung-batched moves too).
        self._program = None
        self._use_graphs = self.device.type == "cuda"
        self._batched = True
        self._move_carries = None
        self.last_run_stats = None

        self.backend = PTBackend() if backend is None else backend
        self._previous_state = None
        if self.backend.initialized:
            if self.backend.shape != (self.ntemps, self.nwalkers, self.ndim):
                raise ValueError(
                    "the shape of the backend is incompatible with the "
                    f"sampler; expected "
                    f"{(self.ntemps, self.nwalkers, self.ndim)}, got "
                    f"{self.backend.shape}"
                )
            if self.backend.iteration > 0:
                self._previous_state = self.backend.get_last_sample()
                saved = getattr(self.backend, "betas", None)
                if saved is not None:
                    saved = np.asarray(saved, dtype=np.float64)
                    if saved.shape == self.betas.shape and np.any(saved):
                        self.betas = saved
        else:
            self.backend.reset(self.ntemps, self.nwalkers, self.ndim)
        self._base_swaps_accepted = np.asarray(self.backend.swaps_accepted,
                                               dtype=np.int64)
        self._base_swaps_proposed = np.asarray(self.backend.swaps_proposed,
                                               dtype=np.int64)

    def _wrap_fns(self):
        self._log_like = wrap_log_prob_fn(self._log_like_fn,
                                          **self._like_settings)
        self._log_prior = wrap_log_prob_fn(self._log_prior_fn,
                                           **self._prior_settings)

    def __getstate__(self):
        d = self.__dict__.copy()
        d.update(_program=None, _log_like=None, _log_prior=None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._blob_signature = _UNKNOWN
        self._wrap_fns()

    def reset(self):
        """Clear the backend and the resume anchor; the move carries
        (per-rung tuned scales) are kept, as in the JAX package."""
        self.backend.reset(self.ntemps, self.nwalkers, self.ndim)
        self._previous_state = None
        self._base_swaps_accepted = np.zeros(max(self.ntemps - 1, 1),
                                             dtype=np.int64)
        self._base_swaps_proposed = np.zeros(max(self.ntemps - 1, 1),
                                             dtype=np.int64)

    @property
    def iteration(self):
        return self.backend.iteration

    @property
    def accepted(self):
        return self.backend.accepted

    @property
    def swaps_accepted(self):
        return self.backend.swaps_accepted

    @property
    def swaps_proposed(self):
        return self.backend.swaps_proposed

    @property
    def acceptance_fraction(self):
        return self.accepted / float(max(self.iteration, 1))

    @property
    def tswap_acceptance_fraction(self):
        return self.swaps_accepted / np.maximum(self.swaps_proposed, 1)

    # ------------------------------------------------------------------
    def _to_device(self, x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               dtype=self.dtype, device=self.device)

    def _init_carries(self):
        """One carry per rung: each tensor of the move's carry with a
        leading ``ntemps`` axis."""
        out = []
        for m in self._moves:
            c = m.init_carry(self.nwalkers, self.ndim, device=self.device)
            if isinstance(c, dict):
                c = {k: v.unsqueeze(0).repeat((self.ntemps,) + (1,) * v.dim())
                     for k, v in c.items()}
            out.append(c)
        return tuple(out)

    def _prepare_state(self, initial_state, skip_check=False, trusted=False):
        """The checked initial state on the device, with its ``log_like``,
        ``log_prior`` and user blobs (evaluated when missing).  A resumed
        state with blobs whose likelihood returns none raises; one
        without blobs whose likelihood returns some is evaluated again
        (``emcee_tpu/parallel/tempering.py:981-1010``)."""
        if isinstance(initial_state, PTState):
            state = initial_state
        else:
            state = PTState(coords=initial_state, log_like=None,
                            log_prior=None)
        ll, lpr, blobs = state.log_like, state.log_prior, state.blobs
        io = self._io_dtype
        if (io is not None and io.itemsize < 4
                and _torch_dtype_or_none(
                    getattr(state.coords, "dtype", None)) == io):
            # Resuming from a store of reduced precision: sample in float32
            # and evaluate again, since the stored values belong to the
            # unrounded coords (emcee_tpu/parallel/tempering.py:932-951).
            ll = lpr = blobs = None
        coords = self._to_device(state.coords)
        shape = (self.ntemps, self.nwalkers, self.ndim)
        if tuple(coords.shape) != shape:
            raise ValueError(f"incompatible input dimensions "
                             f"{tuple(coords.shape)}; expected {shape}")
        if not skip_check and not trusted:
            for t in range(self.ntemps):
                if not walkers_independent(coords[t]):
                    raise ValueError(
                        f"Initial state for temperature {t} has a large "
                        "condition number"
                    )
        rs = state.random_state
        rs = self._rng if rs is None else (int(rs[0]), int(rs[1]))
        if ll is None or lpr is None:
            ll, lpr, blobs = self._evaluate(coords)
            return PTState(coords, ll, lpr, rs, blobs)
        ll, lpr = self._to_device(ll), self._to_device(lpr)
        if self._blob_signature is _UNKNOWN:
            self._evaluate(coords, check=False)
        sig = self._blob_signature
        if blobs is not None:
            if sig is None:
                raise ValueError(
                    "inconsistent use of blobs: the resumed state carries "
                    "blobs but the log-likelihood returns none")
            blobs = self._blobs_to_device(blobs, sig)
        elif sig is not None:
            ll, lpr, blobs = self._evaluate(coords)
            return PTState(coords, ll, lpr, rs, blobs)
        return PTState(coords, ll, lpr, rs, blobs)

    def _evaluate(self, coords, check=True):
        """``(logL, logP, user blobs)`` of every walker of ``(T, nwalkers,
        ndim)`` device coords, noting the blobs' structure; with
        ``check``, a NaN raises."""
        T, nw = self.ntemps, self.nwalkers
        flat = coords.reshape(-1, self.ndim)
        ll, blobs = self._log_like(flat)
        lpr, _ = self._log_prior(flat)
        ll, lpr = ll.reshape(T, nw), lpr.reshape(T, nw)
        blobs = tree_map(lambda b: b.reshape((T, nw) + b.shape[1:]), blobs)
        self._blob_signature = blob_signature(blobs)
        if check and (bool(torch.isnan(ll).any())
                      or bool(torch.isnan(lpr).any())):
            raise ValueError("The initial log-likelihood was NaN")
        return ll, lpr, blobs

    def _blobs_to_device(self, blobs, sig):
        """A given state's user blobs as device tensors in the structure
        and dtypes the likelihood returns; other leaves raise."""
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
                "the leaves the log-likelihood returns")
        return tree_unflatten(sig[0], out)

    def _count_proposed_delta(self, lo, hi):
        """Swap attempts per pair for the proposals at steps ``[lo, hi)``:
        an attempt fires where ``step % swap_every == swap_every - 1``,
        pairing by the step's parity (``emcee_tpu/parallel/tempering.py:
        1111-1130``)."""
        out = np.zeros(max(self.ntemps - 1, 1), dtype=np.int64)
        se = self.swap_every
        if se <= 0:
            return out
        first = lo + ((se - 1 - lo) % se)
        sidxs = np.arange(first, hi, se, dtype=np.int64)
        for parity in (0, 1):
            cnt = int(np.count_nonzero((sidxs % 2) == parity))
            if cnt:
                out[parity: self.ntemps - 1: 2] += cnt * self.nwalkers
        return out

    def _max_chunk(self, blobs=None, store=True):
        """Kept steps a chunk.  With ``adaptive=True``, the JAX package's
        (``emcee_tpu/parallel/tempering.py:1130-1158`` under its default
        float32): every byte of a kept step's rows (coords in
        ``io_dtype``, three 4-byte values a walker, the blob leaves, float
        ones in ``io_dtype``) under ``io_chunk_bytes``, at most 4096, so
        the ladder adapts where the JAX package's does.  Otherwise the
        port's: the stored rows in their stored dtypes under
        ``io_chunk_bytes``, at most 4096 into a host backend and 16384
        into a device backend or unstored."""
        io = self._io_dtype
        n_tw = self.ntemps * self.nwalkers
        leaf_bytes = sum(
            leaf.numel() * (io.itemsize if io is not None
                            and leaf.is_floating_point()
                            else leaf.element_size())
            for leaf in map(torch.as_tensor, tree_leaves(blobs)))
        if self.adaptive:
            row = (n_tw * self.ndim * (io.itemsize if io else 4)
                   + 3 * n_tw * 4 + leaf_bytes)
            return max(1, min(4096, self._io_chunk_bytes // max(1, row)))
        device_rows = getattr(self.backend, "wants_device_arrays", False)
        cap = 16384 if not store or device_rows else 4096
        if store:
            item = 4 if device_rows else np.dtype(self.backend.dtype).itemsize
            row = n_tw * (self.ndim * (io.itemsize if io else item)
                          + 2 * item + 1) + leaf_bytes
            cap = min(cap, max(1, self._io_chunk_bytes // row))
        return cap

    def _adapt_ladder(self, swaps, prev_swaps, chunk_props, done):
        """Diminishing ladder adaptation (Vousden et al. 2016, eq. 11-12;
        ``emcee_tpu/parallel/tempering.py:1057-1088``, the same arithmetic
        in numpy): ``S_i = log(T_{i+1} - T_i)`` moves by ``kappa *
        clip(A_i - A_{i+1}, -1, 1)`` (the last gap holds still), with
        ``A`` the pairs' swap acceptance over the chunk and ``kappa =
        (1 / adaptation_time) * lag / (done + lag)``; ``beta_0`` stays
        pinned.  ``swaps`` are the run's accepted swaps per pair so far,
        ``prev_swaps`` those before this chunk, ``chunk_props`` the
        chunk's proposals and ``done`` the run's.  Returns the new ladder
        and the new running swap counts; pure (the caller commits the
        ladder with the chunk's save)."""
        T = self.ntemps
        if T < 3:
            return np.asarray(self.betas), prev_swaps
        cur = np.asarray(swaps, dtype=np.int64)[: T - 1]
        delta = cur - prev_swaps
        attempts = max(
            (chunk_props // max(self.swap_every, 1)) * self.nwalkers // 2, 1)
        A = delta / attempts
        kappa = (1.0 / self.adaptation_time) * (
            self.adaptation_lag / (done + self.adaptation_lag))
        temps = 1.0 / self.betas
        S = np.log(np.diff(temps))
        grad = np.zeros(T - 1)
        grad[: T - 2] = A[: T - 2] - A[1: T - 1]
        S += kappa * np.clip(grad, -1.0, 1.0)
        temps = np.concatenate([[temps[0]], temps[0] + np.cumsum(np.exp(S))])
        return 1.0 / temps, cur

    # ------------------------------------------------------------------
    def _start(self, state, carries):
        """The tempered program of ``state``'s seed and blob structure,
        loaded with the state, the ladder and the carries."""
        seed, offset = state.random_state
        prog = self._program
        if (prog is None or prog.seed != seed
                or prog.batched != self._batched
                or prog.blob_signature != blob_signature(state.blobs)):
            prog = self._program = TemperedProgram(
                self._moves, self._log_like, self._log_prior,
                rung_keys(seed, self.ntemps, self.device), state.coords,
                carries, self.swap_every, self._batched, state.blobs)
        prog.load(state.coords, state.log_like, state.log_prior,
                  self._betas_tensor(self.betas), offset, carries,
                  state.blobs)
        return prog, offset

    def _betas_tensor(self, betas):
        return torch.as_tensor(np.asarray(betas), dtype=self.dtype,
                               device=self.device)

    def _chunk_rows(self, nkeep, blobs):
        """Where a chunk's kept steps go: a device backend's own rows, or
        device buffers in the host backend's dtype (coords in
        ``io_dtype``, blob leaves in their stored dtypes)."""
        T, nw, nd = self.ntemps, self.nwalkers, self.ndim
        dev, io = self.device, self._io_dtype
        accepted = torch.empty((nkeep, T, nw), dtype=torch.bool, device=dev)
        if getattr(self.backend, "wants_device_arrays", False):
            coords, ll, lpr, rows = self.backend.reserve(
                nkeep, dev, io or self.dtype, self.dtype)
            return coords, ll, lpr, accepted, rows
        dt = torch_dtype(np.dtype(self.backend.dtype))
        rows = tree_map(lambda b: torch.empty(
            (nkeep,) + tuple(b.shape), dtype=stored_dtype(b.dtype, io),
            device=dev), blobs)
        return (torch.empty((nkeep, T, nw, nd), dtype=io or dt, device=dev),
                torch.empty((nkeep, T, nw), dtype=dt, device=dev),
                torch.empty((nkeep, T, nw), dtype=dt, device=dev), accepted,
                rows)

    def _enqueue(self, prog, offset, nkeep, thin_by, store, tune):
        """Enqueue one chunk of ``nkeep * thin_by`` proposals, the runs of
        equal moves that the move sequence gives, and copy its kept rows;
        nothing waits for the device."""
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
                for rows, src in zip(out[:4], (ws.coords, ws.log_like,
                                               ws.log_prior, ws.accepted)):
                    rows[k].copy_(src)
                for rows, b in zip(tree_leaves(out[4]),
                                   tree_leaves(ws.blobs)):
                    rows[k].copy_(b)
        n = nkeep * thin_by
        state = PTState(ws.coords.clone(), ws.log_like.clone(),
                        ws.log_prior.clone(), (prog.seed, offset + n),
                        tree_map(torch.clone, ws.blobs))
        return _Chunk(out, ws.swaps[: max(self.ntemps - 1, 1)].clone(),
                      state, tuple(clone_carry(c) for c in ws.carries), n)

    def _drive(self, initial_state, sizes, thin_by, store, tune,
               skip_check, pregrow=None):
        """Advance the chain chunk by chunk (the engine of
        :meth:`run_mcmc` and :meth:`sample`); yields the state after each
        chunk, once its rows and the resume anchors have committed.
        ``sizes`` may be a function of the prepared state (the schedule
        counts the blobs' bytes)."""
        thin_by = int(thin_by)
        if thin_by <= 0:
            raise ValueError("Invalid thinning argument")
        trusted = False
        if initial_state is None:
            if self._previous_state is None:
                raise ValueError(
                    "Cannot have `initial_state=None` on the first call")
            initial_state = self._previous_state
            trusted = True
        state = self._prepare_state(initial_state, skip_check, trusted)
        if callable(sizes):
            sizes = sizes(state)
        if store and pregrow is not None:
            self.backend.grow(pregrow, grow_blobs_template(state.blobs,
                                                           self._io_dtype))
        carries = self._move_carries or self._init_carries()
        prog, offset = self._start(state, carries)
        proposed = np.zeros(max(self.ntemps - 1, 1), dtype=np.int64)
        prev_swaps = np.zeros(max(self.ntemps - 1, 1), dtype=np.int64)
        done = 0
        try:
            for n in sizes:
                chunk = self._enqueue(prog, offset, int(n), thin_by, store,
                                      tune)
                proposed += self._count_proposed_delta(
                    offset, offset + chunk.proposals)
                offset += chunk.proposals
                done += chunk.proposals
                swaps = chunk.swaps.cpu().numpy().astype(np.int64)
                new_betas = None
                if self.adaptive:
                    new_betas, prev_swaps = self._adapt_ladder(
                        swaps, prev_swaps, chunk.proposals, done)
                    # The next chunk runs on the new ladder either way;
                    # self.betas commits with the save.
                    prog.set_betas(self._betas_tensor(new_betas))
                self._commit(chunk, swaps, proposed, new_betas)
                yield self._previous_state
        finally:
            if store and self.backend.initialized:
                self._base_swaps_accepted = np.asarray(
                    self.backend.swaps_accepted, dtype=np.int64)
                self._base_swaps_proposed = np.asarray(
                    self.backend.swaps_proposed, dtype=np.int64)

    def _commit(self, chunk, swaps, proposed, new_betas=None):
        """Save a chunk and move the resume anchors (and an adapted
        ladder) to it, with SIGINT held between the two: a save that
        fails leaves ``self.betas`` at the ladder the backend holds."""
        betas = self.betas if new_betas is None else new_betas
        with defer_interrupts():
            if chunk.rows is not None:
                rs = chunk.state.random_state
                acc_sw = self._base_swaps_accepted + swaps
                prop_sw = self._base_swaps_proposed + proposed
                if getattr(self.backend, "wants_device_arrays", False):
                    self.backend.commit(chunk.rows[3], acc_sw, prop_sw, rs,
                                        betas)
                else:
                    self.backend.save_chunk(
                        *(r.cpu().numpy() for r in chunk.rows[:4]), acc_sw,
                        prop_sw, rs, betas,
                        blobs=tree_map(lambda r: r.cpu().numpy(),
                                       chunk.rows[4]))
            if new_betas is not None:
                self.betas = np.asarray(new_betas, dtype=np.float64)
            self._previous_state = chunk.state
            self._move_carries = chunk.carries
            self._rng = chunk.state.random_state

    @staticmethod
    def _check_progress(progress):
        if progress:
            raise NotImplementedError(
                "progress bars are not ported yet (ROADMAP P12)")

    def run_mcmc(self, initial_state, nsteps, thin_by=1, store=True,
                 tune=False, skip_initial_state_check=False, progress=False,
                 progress_kwargs=None, thin=None):
        """Run ``nsteps`` kept steps; returns the final :class:`PTState`.
        ``initial_state=None`` continues the previous run; ``thin=`` is
        the deprecated argument (counts proposals)."""
        self._check_progress(progress)
        if thin is not None:
            nsteps, thin_by = shim_thin(nsteps, thin)
        nsteps, thin_by = int(nsteps), int(thin_by)
        if nsteps == 0:
            return self._prepare_state(
                initial_state if initial_state is not None
                else self._previous_state, skip_initial_state_check)
        blk = self._mixture_block if len(self._moves) > 1 else 1

        def sizes(state):
            return chunk_schedule(nsteps,
                                  self._max_chunk(state.blobs, store), blk)

        t0 = time.perf_counter()
        for _ in self._drive(initial_state, sizes, thin_by, store, tune,
                             skip_initial_state_check, pregrow=nsteps):
            pass
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_run_stats = RunStats(
            nsteps=nsteps, nproposals=nsteps * thin_by,
            nwalkers=self.ntemps * self.nwalkers,
            walltime_s=time.perf_counter() - t0,
            accepted=self._program.ws.count.clone())
        return self._previous_state

    def sample(self, initial_state, iterations=1, thin_by=1, store=True,
               tune=False, skip_initial_state_check=False, progress=False,
               progress_kwargs=None, thin=None):
        """Generator yielding a :class:`PTState` every ``thin_by``
        proposals; ``iterations=None`` streams forever with
        ``store=False``."""
        self._check_progress(progress)
        if iterations is None and store:
            raise ValueError(
                "'store' must be False when 'iterations' is None")
        if thin is not None:
            iterations, thin_by = shim_thin(iterations, thin)
        if iterations is None:
            import itertools

            sizes = itertools.repeat(1)
        else:
            sizes = [1] * int(iterations)
        yield from self._drive(initial_state, sizes, thin_by, store, tune,
                               skip_initial_state_check, pregrow=iterations)

    # ------------------------------------------------------------------
    def get_chain(self, discard=0, thin=1, flat=False, temp=None):
        """Stored chain ``(it, T, nw, nd)`` (or one rung with ``temp``)."""
        return self.backend.get_chain(discard=discard, thin=thin, flat=flat,
                                      temp=temp)

    def get_log_like(self, discard=0, thin=1):
        return self.backend.get_log_like(discard=discard, thin=thin)

    def get_log_prior(self, discard=0, thin=1):
        return self.backend.get_log_prior(discard=discard, thin=thin)

    def get_blobs(self, discard=0, thin=1, temp=None):
        """Stored user blobs with leaves ``(it, T, nwalkers, ...)`` (one
        rung's with ``temp``), or None when the likelihood returns none;
        :class:`~..backends.PTHDFBackend` rebuilds the pytree from its
        record array."""
        return self.backend.get_blobs(discard=discard, thin=thin, temp=temp)

    def get_last_sample(self):
        return self.backend.get_last_sample()

    def get_autocorr_time(self, discard=0, thin=1, temp=0, **kwargs):
        x = self.get_chain(discard=discard, thin=thin, temp=temp)
        return thin * integrated_time(x, **kwargs)

    def log_evidence_estimate(self, discard=0, method="ti",
                              return_error=False):
        """ln-evidence estimate from the stored tempered chains
        (``emcee_tpu/parallel/tempering.py:1480-1553``): ``"ti"``,
        trapezoid thermodynamic integration of the ladder of mean
        log-likelihoods, or ``"stepping-stone"`` (Xie et al. 2011); with
        ``return_error``, also ``|lnZ - lnZ(every other rung)|``.  Both
        close the segment below the hottest rung with ``beta_min *
        mean_ll[hottest]`` and weight the samples by ``self.betas``."""
        ll = np.asarray(self.get_log_like(discard=discard))  # (it, T, nw)
        order = np.argsort(self.betas)
        b = self.betas[order]
        ll = ll[:, order, :]
        trapezoid = getattr(np, "trapezoid", None) or np.trapz

        def estimate(b, ll):
            mean_ll = ll.mean(axis=(0, 2))
            tail = b[0] * mean_ll[0] if b[0] > 0 else 0.0
            if method == "ti":
                return trapezoid(mean_ll, b) + tail
            if method == "stepping-stone":
                samples = ll.transpose(1, 0, 2).reshape(ll.shape[1], -1)
                lnz = tail
                for k in range(len(b) - 1):
                    w = (b[k + 1] - b[k]) * samples[k]
                    wmax = np.max(w)
                    lnz += wmax + np.log(np.mean(np.exp(w - wmax)))
                return lnz
            raise ValueError(f"unknown evidence method {method!r}; use "
                             "'ti' or 'stepping-stone'")

        lnz = estimate(b, ll)
        if not return_error:
            return lnz
        keep = np.zeros(len(b), dtype=bool)
        keep[len(b) - 1:: -2] = True
        lnz2 = estimate(b[keep], ll[:, keep, :])
        return lnz, abs(lnz - lnz2)

