"""Carry state, move carries and stored chains across from the JAX
package.

Every function takes plain numpy arrays (``np.asarray`` of the JAX
package's arrays), so this module imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .backends import Backend
from .state import State, resolve_device

__all__ = ["backend_from_numpy", "carry_from_numpy", "state_from_numpy"]


def state_from_numpy(coords, log_prob=None, seed=0, device=None):
    """A port :class:`State` from an ensemble's numpy arrays, with the
    random state ``(seed, 0)``; ``device`` as for the sampler."""
    dev = resolve_device(device)

    def put(x):
        return None if x is None else torch.as_tensor(
            np.asarray(x, dtype=np.float32), device=dev
        )

    return State(put(coords), put(log_prob), None, (int(seed), 0))


def backend_from_numpy(chain, log_prob, accepted, random_state=None):
    """A port :class:`Backend` holding a stored chain: ``chain``
    ``(iteration, nwalkers, ndim)``, ``log_prob`` ``(iteration,
    nwalkers)`` and the cumulative ``accepted`` counts ``(nwalkers,)``."""
    chain = np.asarray(chain)
    backend = Backend()
    backend.reset(chain.shape[1], chain.shape[2])
    backend.save_chunk(
        chain, np.asarray(log_prob), None,
        np.asarray(accepted, dtype=np.int64)[None], random_state,
    )
    return backend


def carry_from_numpy(carry, device=None):
    """A move's tuning carry in the port's form: the JAX package's
    ``{"log_adj": f32, "t": int32}`` (``emcee_tpu/moves/base.py:80-99``)
    as 0-d tensors on ``device``, so a tuned scale resumes where the JAX
    run left it; an untuned move's ``()`` stays ``()``."""
    if not isinstance(carry, dict):
        if len(carry):
            raise ValueError(f"not a tuning carry: {carry!r}")
        return ()
    if set(carry) != {"log_adj", "t"}:
        raise ValueError(f"not a tuning carry: keys {sorted(carry)}")
    dev = resolve_device(device)
    return {
        "log_adj": torch.tensor(np.float32(carry["log_adj"]), device=dev),
        "t": torch.tensor(np.int32(carry["t"]), device=dev),
    }
