"""Red-blue ensemble-split proposal engine.

The counterpart of ``emcee_tpu/moves/red_blue.py:42-355``.  The ensemble
is split into ``nsplits`` groups; each group is updated against the
frozen others, so detailed balance holds (Foreman-Mackey et al. 2013,
Algorithm 2).  Per split the engine runs K1 (the concrete move's
proposal), the user's log-prob, and K2 (accept/select, written in place
into the ensemble buffer).

* ``randomize_split=False`` (blocked): group j is the contiguous rows
  ``[j*ng, (j+1)*ng)``; K1 reads its complement in place and K2 writes
  its rows in place.  No gather, no scatter, no sort.
* ``randomize_split=True`` (shuffled, the reference default): group
  membership is a permutation drawn from the ``(seed, offset)`` stream
  (a stable argsort of Philox word 3, computed on the walkers' device
  from the offset, which may be a device word, so the CPU and the card
  draw the same one and nothing waits for the host); the ensemble is
  gathered into contiguous buffers in group order, the blocked engine
  runs on them, and the rows are scattered back.  Group j is
  ``perm[j::nsplits]``, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..ops import accept_kernel
from ..ops.philox import walker_words
from .base import Move, ScaleTunable

__all__ = ["RedBlueMove", "shuffled_order"]


def shuffled_order(rng, nwalkers, nsplits, device):
    """Walker rows in group order for the shuffled split: the rows of
    group j are ``order[j*ng:(j+1)*ng]``."""
    seed, offset = rng
    w3 = walker_words(nwalkers, nsplits, seed, offset, device)[3]
    perm = torch.argsort(w3, stable=True)
    return perm.view(nwalkers // nsplits, nsplits).t().reshape(-1)


class RedBlueMove(ScaleTunable, Move):
    """Abstract parallelizable ensemble move.

    Args:
        nsplits: Number of sub-ensembles (reference default 2).
        randomize_split: Shuffle group membership every proposal
            (reference default True).  ``False`` selects the blocked
            path.
        live_dangerously: Skip the ``nwalkers >= 2 * ndim`` guard.
        tune_target: optional target acceptance rate for
            ``run_mcmc(..., tune=True)`` (tunable moves only).
        tune_rate: adaptation step size (decays as ``1/sqrt(t)``).

    Subclasses implement ``get_proposal(rng, coords, split, model,
    extra=None, scale=None) -> (q, factors)`` for group ``split`` of the
    contiguous ensemble buffer ``coords``.
    """

    tunable = False

    def __init__(self, nsplits=2, randomize_split=True, live_dangerously=False,
                 tune_target=None, tune_rate=0.2):
        self.nsplits = int(nsplits)
        self.randomize_split = bool(randomize_split)
        self.live_dangerously = bool(live_dangerously)
        if tune_target is not None and not self.tunable:
            raise ValueError(
                f"{type(self).__name__} does not support tune_target "
                "(no adaptable proposal scale)"
            )
        self.tune_target = tune_target
        self.tune_rate = float(tune_rate)

    def get_proposal(self, rng, coords, split, model, extra=None,
                     scale=None):
        raise NotImplementedError(
            "The proposal must be implemented by subclasses"
        )

    def propose(self, rng, state, model, carry, acc_count=None,
                accepted=None):
        nwalkers, ndim = state.coords.shape
        nglobal = model.nwalkers or nwalkers
        if nglobal < 2 * model.global_ndim(ndim) and not self.live_dangerously:
            raise RuntimeError(
                "It is unadvisable to use a red-blue move with fewer "
                "walkers than twice the number of dimensions."
            )
        if nwalkers % self.nsplits != 0:
            raise ValueError(
                f"nwalkers ({nwalkers}) must be divisible by "
                f"nsplits ({self.nsplits})"
            )
        ng = nwalkers // self.nsplits
        scale = self._tuned_scale(carry, state.coords.dtype)
        if self.randomize_split:
            return self._propose_shuffled(
                rng, state, model, carry, ng, scale, acc_count, accepted
            )
        return self._propose_blocked(
            rng, state, model, carry, ng, scale, acc_count,
            accepted=accepted,
        )

    def _inner(self, rng, coords, log_prob, split, model, accepted,
               acc_count=None, log_u=None, extra=None, scale=None):
        """Propose (K1), evaluate, and accept (K2) for one group; the
        group's rows of ``coords``/``log_prob``/``accepted`` are updated
        in place."""
        q, factors = self.get_proposal(
            rng, coords, split, model, extra=extra, scale=scale
        )
        new_lp, _ = model.compute_log_prob(q)
        seed, offset = rng
        accept_kernel.accept_select(
            q, factors, new_lp, coords, log_prob, split, self.nsplits,
            accepted, acc_count, seed=seed, offset=offset, log_u=log_u,
        )

    def _propose_blocked(self, rng, state, model, carry, ng, scale=None,
                         acc_count=None, log_acc_u=None, extra_u=None,
                         accepted=None):
        """Fixed contiguous-block membership; ``log_acc_u``
        ``(nsplits, ng)`` and ``extra_u`` ``(nsplits, n_extra)`` inject
        the uniforms (parity mode), as in the JAX package.  ``accepted``:
        the ``(nwalkers,)`` bool buffer K2 writes (a new one if None)."""
        if accepted is None:
            accepted = torch.empty(
                state.coords.shape[0], dtype=torch.bool,
                device=state.coords.device,
            )
        for split in range(self.nsplits):
            self._inner(
                rng, state.coords, state.log_prob, split, model, accepted,
                acc_count,
                log_u=None if log_acc_u is None else log_acc_u[split],
                extra=None if extra_u is None else extra_u[split],
                scale=scale,
            )
        return state, accepted, carry

    def _propose_shuffled(self, rng, state, model, carry, ng, scale=None,
                          acc_count=None, accepted=None):
        """Random membership: gather into group order, run the blocked
        engine, scatter back."""
        coords, log_prob = state.coords, state.log_prob
        order = shuffled_order(
            rng, coords.shape[0], self.nsplits, coords.device
        )
        buf = state._replace(
            coords=coords.index_select(0, order),
            log_prob=log_prob.index_select(0, order),
        )
        count = None if acc_count is None else acc_count.index_select(0, order)
        _, acc_buf, carry = self._propose_blocked(
            rng, buf, model, carry, ng, scale, count
        )
        coords.index_copy_(0, order, buf.coords)
        log_prob.index_copy_(0, order, buf.log_prob)
        if acc_count is not None:
            acc_count.index_copy_(0, order, count)
        if accepted is None:
            accepted = torch.empty_like(acc_buf)
        accepted.index_copy_(0, order, acc_buf)
        return state, accepted, carry
