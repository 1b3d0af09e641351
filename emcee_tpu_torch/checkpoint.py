"""State checkpoints.

The counterpart of ``emcee_tpu/checkpoint.py:63-95`` (``save_state``,
``load_state``).  The JAX package writes a sharded Orbax checkpoint; the
port, on one device, writes one file with ``torch.save``: the state's
tensors, its blob leaves (a pytree of tensors) and the Philox ``(seed,
offset)`` as two integers.  It is read back with
``torch.load(..., weights_only=True)``, which unpickles only tensors and
plain containers.  A checkpoint of one package cannot be read by the
other.  Typical pattern::

    from emcee_tpu_torch import checkpoint

    state = sampler.run_mcmc(state, 1000, store=False)
    checkpoint.save_state("run1.pt", state)
    ...
    state = checkpoint.load_state("run1.pt")
    sampler.run_mcmc(state, 1000, store=False)
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from .state import State, as_state, resolve_device
from .utils import tree_map

__all__ = ["load_state", "save_state"]


def _tensor(x):
    if x is None or isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x))


def save_state(path: str, state: Any, force: bool = True) -> None:
    """Checkpoint ``state`` (a :class:`~.state.State` or what the sampler
    takes as one) to the file ``path``.  An existing file is replaced
    unless ``force`` is False, which raises ``FileExistsError``.  The file
    appears whole or not at all (written beside it, then renamed)."""
    path = os.path.abspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    state = as_state(state)
    rs = state.random_state
    payload = {
        "coords": _tensor(state.coords),
        "log_prob": _tensor(state.log_prob),
        "blobs": tree_map(_tensor, state.blobs),
        "random_state": None if rs is None else (int(rs[0]), int(rs[1])),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_state(path: str, like: Optional[Any] = None, device=None) -> State:
    """Restore a :class:`~.state.State` saved by :func:`save_state`.

    Args:
        path: the checkpoint file.
        like: optional state whose coords' device the tensors go to.
        device: where the tensors go without ``like``; ``None`` means the
            card, as for the sampler.
    """
    dev = (like.coords.device if like is not None
           and isinstance(like.coords, torch.Tensor)
           else resolve_device(device))
    data = torch.load(os.path.abspath(path), map_location=dev,
                      weights_only=True)
    rs = data["random_state"]
    return State(data["coords"], data["log_prob"], data["blobs"],
                 None if rs is None else (int(rs[0]), int(rs[1])))
