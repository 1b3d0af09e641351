"""Ensemble state container.

The counterpart of ``emcee_tpu.state`` (``emcee_tpu/state.py:28-268``) for
the PyTorch port.  The fields, the positional-constructor order and the
reference's legacy 3-tuple unpack are the same; what differs:

* ``coords`` and ``log_prob`` are ``torch.Tensor``s on one device (numpy
  arrays when a host backend hands a stored sample back);
* ``random_state`` is the port's counter-based generator state, a
  ``(seed, offset)`` pair of Python ints (see ``ops/philox.py``): the
  64-bit Philox key and the number of proposals already drawn.  Being a
  pair of ints it round-trips through every backend unchanged, so there
  is no ``coerce_random_state``;
* the sampler updates the tensors of its working state in place (the
  red-blue accept kernel writes accepted rows straight into the ensemble
  buffer); it copies a caller's state before the first proposal, so a
  state a caller holds is never written to.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .utils import tree_map

__all__ = ["State", "as_state", "resolve_device", "walkers_independent"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another.  ``None`` means ``"cuda"``, and asking for CUDA on a
    machine without a GPU raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "emcee_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


class State(NamedTuple):
    """A snapshot of the walker ensemble.

    Field (= positional-constructor) order is ``State(coords, log_prob,
    blobs, random_state)``; iteration follows the reference's legacy
    unpack order ``coords, log_prob, random_state`` (``blobs`` appended
    when present).

    Fields
    ------
    coords:
        ``(nwalkers, ndim)`` walker positions.
    log_prob:
        ``(nwalkers,)`` log-probabilities, or ``None`` before the first
        evaluation.
    blobs:
        Optional pytree (a tensor, or a tuple, list or dict of them) of
        per-walker metadata with leading axis ``nwalkers``, or the
        structured record row a backend returns for a declared
        ``blobs_dtype``.
    random_state:
        ``(seed, offset)``: the Philox key and the next proposal's
        counter, or ``None``.
    """

    coords: Any
    log_prob: Optional[Any] = None
    blobs: Optional[Any] = None
    random_state: Optional[tuple] = None

    def __iter__(self):
        c, lp, blobs, rs = tuple.__getitem__(self, slice(0, 4))
        if blobs is None:
            return iter((c, lp, rs))
        return iter((c, lp, rs, blobs))

    def __len__(self) -> int:
        return 3 if tuple.__getitem__(self, 2) is None else 4

    def __getitem__(self, index):
        logical = tuple(iter(self))
        if isinstance(index, slice):
            return logical[index]
        if index < 0:
            index = len(logical) + index
        if 0 <= index < len(logical):
            return logical[index]
        raise IndexError("Invalid index '{0}'".format(index))

    @property
    def nwalkers(self) -> int:
        return self.coords.shape[0]

    @property
    def ndim(self) -> int:
        return self.coords.shape[1]

    def __repr__(self):
        return (
            "State(coords={0!r}, log_prob={1!r}, blobs={2!r}, "
            "random_state={3!r})".format(
                tuple(getattr(self.coords, "shape", ())),
                None
                if self.log_prob is None
                else tuple(getattr(self.log_prob, "shape", ())),
                tree_map(lambda b: tuple(getattr(b, "shape", ())),
                         self.blobs),
                self.random_state,
            )
        )


# typing.NamedTuple forbids overriding these in the class body; attach
# iteration-free versions (the stdlib ones build from ``iter(self)``,
# which the legacy unpack above redefines).
def _state_new(
    cls, coords, log_prob=None, blobs=None, random_state=None, copy=False
):
    if hasattr(coords, "coords"):
        # Copy-constructor form ``State(other_state[, copy=True])``.
        def dc(x):
            if not copy or x is None:
                return x
            if isinstance(x, torch.Tensor):
                return x.clone()
            return np.array(x, copy=True) if isinstance(x, np.ndarray) else x

        return tuple.__new__(
            cls,
            (
                dc(coords.coords),
                dc(getattr(coords, "log_prob", None)),
                tree_map(dc, getattr(coords, "blobs", None)),
                getattr(coords, "random_state", None),
            ),
        )
    return tuple.__new__(cls, (coords, log_prob, blobs, random_state))


def _state_replace(self, **kwds):
    fields = {
        name: tuple.__getitem__(self, i)
        for i, name in enumerate(State._fields)
    }
    for name in kwds:
        if name not in fields:
            raise ValueError(f"Got unexpected field names: {[name]!r}")
    fields.update(kwds)
    return State(**fields)


def _state_make(cls, iterable):
    values = tuple(iterable)
    if not 1 <= len(values) <= 4:
        raise TypeError(f"Expected 1-4 arguments, got {len(values)}")
    return tuple.__new__(cls, values + (None,) * (4 - len(values)))


def _state_asdict(self):
    return {
        name: tuple.__getitem__(self, i)
        for i, name in enumerate(State._fields)
    }


State.__new__ = _state_new
State._replace = _state_replace
State._make = classmethod(_state_make)
State._asdict = _state_asdict
State.__getnewargs__ = lambda self: tuple(
    tuple.__getitem__(self, slice(0, 4))
)


def as_state(initial_state) -> State:
    """Coerce user input (array, tensor, tuple, or State) into a ``State``.

    A bare ``(nwalkers, ndim)`` array becomes a state with no log-prob;
    a ``State`` passes through; tuples follow the legacy unpack order
    ``(coords[, log_prob[, random_state[, blobs]]])``.  Arrays are left
    as they are: the sampler moves them to its device and dtype.
    """
    if isinstance(initial_state, State):
        return initial_state
    if isinstance(initial_state, (tuple, list)):
        names = ("coords", "log_prob", "random_state", "blobs")
        if len(initial_state) > 4:
            raise ValueError(
                "cannot coerce a tuple of length "
                f"{len(initial_state)} into a State"
            )
        return State(**dict(zip(names, initial_state)))
    return State(coords=initial_state)


def walkers_independent(coords) -> bool:
    """Condition-number check on the initial ensemble.

    Same contract as ``emcee_tpu.state.walkers_independent`` (reference
    ``ensemble.py:653-663``): the centered, column-scaled walker matrix
    must have a condition number below 1e8.  Runs on the host in float64.
    """
    if isinstance(coords, torch.Tensor):
        C = coords.detach().cpu().double().numpy()
    else:
        C = np.asarray(coords)
        if C.dtype != np.longdouble:
            C = C.astype(np.float64)
    if not np.all(np.isfinite(C)):
        return False
    C = C - np.mean(C, axis=0)[None, :]
    C_colmax = np.amax(np.abs(C), axis=0)
    if np.any(C_colmax == 0):
        return False
    C = C / C_colmax
    C_colsum = np.sqrt(np.sum(C**2, axis=0))
    C = C / C_colsum
    return np.linalg.cond(C.astype(float)) <= 1e8
