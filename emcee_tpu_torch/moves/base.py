"""Move protocol.

The counterpart of ``emcee_tpu/moves/base.py:38-151``:

* ``propose(rng, state, model, carry, acc_count=None, accepted=None)
  -> (state, accepted, carry)``, where ``rng`` is the proposal's
  ``(seed, offset)`` (the JAX key's place; ``offset`` an int or a
  :class:`~..ops.philox.DeviceOffset`) and ``accepted`` is a
  ``(nwalkers,)`` bool tensor, written into the given buffer when there
  is one.  Red-blue moves update ``state``'s tensors in place and add
  the acceptance to ``acc_count`` when it is given;
* per-move adaptive state lives in ``carry``, a small dict of 0-d
  tensors made by ``init_carry``, so tuning never needs a host sync;
* ``tune(carry, state, accepted, model=None) -> carry`` updates the
  carry's tensors in place (and returns it), so a proposal recorded into
  a CUDA graph reads and writes the same carry at every replay.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

__all__ = [
    "Move",
    "ScaleTunable",
    "accept_update",
    "robbins_monro_step",
    "robbins_monro_tune",
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
    """Nudge ``carry["log_adj"]`` toward the acceptance rate ``target``."""
    acc_rate = accepted.to(torch.float32).mean()
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


def accept_update(state, q, new_log_prob, accepted):
    """Whole-ensemble select: keep proposals where accepted (reference
    ``move.py:12-45``)."""
    coords = torch.where(accepted[:, None], q, state.coords)
    log_prob = torch.where(accepted, new_log_prob, state.log_prob)
    return state._replace(coords=coords, log_prob=log_prob)


class Move:
    """Base class; concrete moves implement :meth:`propose`."""

    def init_carry(self, nwalkers: int, ndim: int, device=None) -> Any:
        """Per-move carried state (default: none)."""
        return ()

    def propose(self, rng, state, model, carry, acc_count=None,
                accepted=None) -> Tuple[Any, torch.Tensor, Any]:
        raise NotImplementedError

    def tune(self, carry, state, accepted, model=None) -> Any:
        """Adaptation hook; default no-op (reference ``move.py:9-10``)."""
        return carry
