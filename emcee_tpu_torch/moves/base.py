"""Move protocol.

The counterpart of ``emcee_tpu/moves/base.py:38-151``:

* ``propose(rng, state, model, carry, acc_count=None, accepted=None)
  -> (state, accepted, carry)``, where ``rng`` is the proposal's
  ``(seed, offset)`` (the JAX key's place; ``offset`` an int or a
  :class:`~..ops.philox.DeviceOffset`) and ``accepted`` is a
  ``(nwalkers,)`` bool tensor, written into the given buffer when there
  is one.  Red-blue moves update ``state``'s tensors in place and add
  the acceptance to ``acc_count`` when it is given;
* per-move adaptive state lives in ``carry``, a dict of tensors (0-d
  tuning words, or the archive and moments of the adaptive moves) made
  by ``init_carry``, so adaptation never needs a host sync;
* a move with ``wants_tune_flag`` is proposed with ``tune=`` the run's
  flag (ChEES-HMC estimates its trajectory gradient only when tuning);
* ``tune(carry, state, accepted, model=None) -> carry`` updates the
  carry's tensors in place (and returns it), so a proposal recorded into
  a CUDA graph reads and writes the same carry at every replay.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..utils import tree_flatten, tree_map

__all__ = [
    "Move",
    "ScaleTunable",
    "accept_update",
    "blob_pairs",
    "robbins_monro_step",
    "robbins_monro_tune",
    "tree_where",
]


def robbins_monro_step(carry, err, rate):
    """One Robbins-Monro update of the ``{log_adj, t}`` carry, in place:
    nudge ``log_adj`` by ``err`` with a ``rate / sqrt(1 + t)`` step."""
    t = carry["t"]
    lr = rate / torch.sqrt(1.0 + t.to(torch.float32))
    carry["log_adj"].copy_(
        torch.clamp(carry["log_adj"] + lr * err, -10.0, 10.0))
    t.add_(1)
    return carry


def robbins_monro_tune(carry, accepted, target, rate, model=None):
    """Nudge ``carry["log_adj"]`` toward the acceptance rate ``target``:
    ``accepted`` is one ensemble's ``(nw,)``, or ``(T, nw)`` for a ``(T,)``
    carry of ``T`` rungs, each on its own rate."""
    acc_rate = accepted.to(torch.float32).mean(dim=-1)
    return robbins_monro_step(carry, acc_rate - target, rate)


class ScaleTunable:
    """Mixin: the Robbins-Monro tunable-scale carry protocol."""

    tune_target = None
    tune_rate = 0.2

    def init_carry(self, nwalkers, ndim, device=None):
        if self.tune_target is None:
            return ()
        return {
            "log_adj": torch.zeros((), dtype=torch.float32, device=device),
            "t": torch.zeros((), dtype=torch.int32, device=device),
        }

    def tune(self, carry, state, accepted, model=None):
        if self.tune_target is None:
            return carry
        return robbins_monro_tune(
            carry, accepted, self.tune_target, self.tune_rate, model
        )

    @staticmethod
    def _tuned_scale(carry, dtype):
        """The carry's scale multiplier (a 0-d tensor), or None when
        untuned."""
        if isinstance(carry, dict) and "log_adj" in carry:
            return torch.exp(carry["log_adj"]).to(dtype)
        return None


def blob_pairs(new_blobs, blobs):
    """K2's blob leaf pairs ``[(new rows, buffer), ...]`` of a proposal's
    blobs and the state's blob buffers, leaf by leaf; ``[]`` when the
    log-prob returns no blobs.  A state without blobs whose log-prob
    returns some raises, as the JAX package does
    (``emcee_tpu/moves/red_blue.py:330-335``)."""
    if new_blobs is None:
        return []
    if blobs is None:
        raise ValueError(
            "If you start sampling with a given log_prob, you "
            "also need to provide the current list of blobs at "
            "that position."
        )
    new_leaves, new_def = tree_flatten(new_blobs)
    leaves, treedef = tree_flatten(blobs)
    if new_def != treedef:
        raise ValueError("inconsistent use of blobs: the log-prob's blob "
                         "structure differs from the state's")
    return [(n.contiguous(), b) for n, b in zip(new_leaves, leaves)]


def tree_where(mask, new, old):
    """Per-walker select over a blob pytree; ``mask`` ``(nwalkers,)``
    (``emcee_tpu/moves/base.py`` ``tree_where``)."""
    if old is None:
        return new

    def sel(n, o):
        return torch.where(mask.view((-1,) + (1,) * (n.dim() - 1)), n, o)

    return tree_map(sel, new, old)


def accept_update(state, q, new_log_prob, accepted, new_blobs=None):
    """Whole-ensemble select: keep proposals where accepted (reference
    ``move.py:12-45``), the blobs too when the log-prob returns them."""
    coords = torch.where(accepted[:, None], q, state.coords)
    log_prob = torch.where(accepted, new_log_prob, state.log_prob)
    blobs = state.blobs
    if new_blobs is not None:
        blobs = tree_where(accepted, new_blobs, state.blobs)
    return state._replace(coords=coords, log_prob=log_prob, blobs=blobs)


class Move:
    """Base class; concrete moves implement :meth:`propose`."""

    #: True for a move whose proposal runs loops of a data-dependent
    #: length; the chunk program then runs it by block replays
    #: (``chunk_graph.GraphLoops``) and passes ``loops=`` to propose
    looped = False
    #: True for a move whose proposal depends on the run's ``tune`` flag;
    #: the chunk program then passes ``tune=`` to propose
    #: (``emcee_tpu/sampler.py:733-738``)
    wants_tune_flag = False
    #: iterations a looped move's loop graph holds (``GraphLoops``)
    loop_block = 1

    def init_carry(self, nwalkers: int, ndim: int, device=None) -> Any:
        """Per-move carried state (default: none)."""
        return ()

    def propose(self, rng, state, model, carry, acc_count=None,
                accepted=None) -> Tuple[Any, torch.Tensor, Any]:
        raise NotImplementedError

    def tune(self, carry, state, accepted, model=None) -> Any:
        """Adaptation hook; default no-op (reference ``move.py:9-10``)."""
        return carry
