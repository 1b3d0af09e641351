"""Carry state (with its blobs), move carries and stored chains (with
their blobs) across from the JAX package.

Every function takes plain numpy arrays (``np.asarray`` of the JAX
package's arrays), so this module imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .backends import Backend, PTBackend
from .state import State, resolve_device
from .utils import tree_map

__all__ = ["backend_from_numpy", "carry_from_numpy", "pt_backend_from_numpy",
           "pt_state_from_numpy", "state_from_numpy"]


def state_from_numpy(coords, log_prob=None, seed=0, device=None,
                     blobs=None):
    """A port :class:`State` from an ensemble's numpy arrays, with the
    random state ``(seed, 0)``; ``device`` as for the sampler.  ``blobs``
    is the JAX state's blob pytree (numpy leaves, each kept in its
    dtype)."""
    dev = resolve_device(device)

    def put(x):
        return None if x is None else torch.as_tensor(
            np.asarray(x, dtype=np.float32), device=dev
        )

    blobs = tree_map(lambda b: torch.as_tensor(np.asarray(b), device=dev),
                     blobs)
    return State(put(coords), put(log_prob), blobs, (int(seed), 0))


def backend_from_numpy(chain, log_prob, accepted, random_state=None,
                       blobs=None):
    """A port :class:`Backend` holding a stored chain: ``chain``
    ``(iteration, nwalkers, ndim)``, ``log_prob`` ``(iteration,
    nwalkers)``, the cumulative ``accepted`` counts ``(nwalkers,)`` and
    the stored blobs (a pytree of ``(iteration, nwalkers, ...)`` arrays,
    as the JAX package's ``get_blobs()`` gives them without a declared
    ``blobs_dtype``)."""
    chain = np.asarray(chain)
    backend = Backend()
    backend.reset(chain.shape[1], chain.shape[2])
    backend.save_chunk(
        chain, np.asarray(log_prob), tree_map(np.asarray, blobs),
        np.asarray(accepted, dtype=np.int64)[None], random_state,
    )
    return backend


#: the carries a JAX run's moves hand on: their keys -> each key's dtype
#: (``emcee_tpu/moves/base.py:80-99``, ``de_z.py:122-142``,
#: ``dime.py:108-125``, ``slice.py:106-136``, ``gradient.py:441-459``)
_CARRIES = (
    {"log_adj": np.float32, "t": np.int32},
    {"z": np.float32, "filled": np.int32, "ptr": np.int32, "t": np.int32},
    {"mean": np.float32, "cov": np.float32, "w": np.float32},
    {"log_adj": np.float32, "t": np.int32, "frac_expand": np.float32},
    {"log_adj": np.float32, "t": np.int32, "log_T": np.float32,
     "m": np.float32, "v": np.float32, "k": np.int32, "g": np.float32,
     "n": np.int32},
)


def carry_from_numpy(carry, device=None):
    """A move's carry in the port's form, so an adapted move resumes where
    the JAX run left it: the tuning carry ``{log_adj, t}`` (the gradient
    moves' too), the slice move's ``{log_adj, t, frac_expand}``, DE-Z's
    archive ``{z, filled, ptr, t}``, DIME's moments ``{mean, cov, w}``
    (one component or K) and ChEES-HMC's ``{log_adj, t, log_T, m, v, k,
    g, n}``,
    each leaf a tensor of its JAX dtype and shape on ``device``; an
    untuned move's ``()`` stays ``()``.  Any other carry is refused."""
    if not isinstance(carry, dict):
        if len(carry):
            raise ValueError(f"not a move carry: {carry!r}")
        return ()
    kinds = [k for k in _CARRIES if set(k) == set(carry)]
    if not kinds:
        raise ValueError(f"not a move carry: keys {sorted(carry)}")
    dev = resolve_device(device)
    return {key: torch.as_tensor(np.array(carry[key], dtype=dt), device=dev)
            for key, dt in kinds[0].items()}


def pt_state_from_numpy(coords, log_like=None, log_prior=None, seed=0,
                        device=None, blobs=None):
    """A port :class:`~.parallel.PTState` from a tempered ensemble's numpy
    arrays (``coords`` ``(T, nwalkers, ndim)``, ``log_like`` and
    ``log_prior`` ``(T, nwalkers)``, the user blobs a pytree of ``(T,
    nwalkers, ...)`` leaves, each kept in its dtype, as a JAX ``PTState``
    holds them), with the random state ``(seed, 0)``; ``device`` as for
    the sampler."""
    from .parallel import PTState

    dev = resolve_device(device)

    def put(x):  # a copy: a JAX array's numpy view is read-only
        return None if x is None else torch.tensor(
            np.array(x, dtype=np.float32), device=dev)

    blobs = tree_map(lambda b: torch.tensor(np.array(b), device=dev), blobs)
    return PTState(put(coords), put(log_like), put(log_prior),
                   (int(seed), 0), blobs)


def pt_backend_from_numpy(chain, log_like, log_prior, accepted,
                          swaps_accepted, swaps_proposed, betas,
                          random_state=None, blobs=None):
    """A port :class:`~.backends.PTBackend` holding a stored tempered
    chain: ``chain`` ``(iteration, T, nwalkers, ndim)``, ``log_like`` and
    ``log_prior`` ``(iteration, T, nwalkers)``, the cumulative
    ``accepted`` counts ``(T, nwalkers)``, the swap counters, the ladder
    (a sampler opened on the backend resumes it) and the stored blobs (a
    pytree of ``(iteration, T, nwalkers, ...)`` arrays), as a JAX
    ``PTBackend`` holds them."""
    chain = np.asarray(chain)
    backend = PTBackend()
    backend.reset(*chain.shape[1:])
    backend.save_chunk(
        chain, np.asarray(log_like), np.asarray(log_prior),
        np.asarray(accepted, dtype=np.int64)[None], swaps_accepted,
        swaps_proposed, random_state, betas,
        blobs=tree_map(np.asarray, blobs))
    return backend
