"""Metropolis-Hastings move (not an ensemble move).

The counterpart of ``emcee_tpu/moves/mh.py:27-84``: the whole ensemble
is proposed at once by a user function, then accepted where ``log U <
lnpdiff``.  The accept/select runs through K2 (``ops/accept_kernel.py``)
as split 0 of ``nsplits=1``: the accept uniform is Philox word 1 at
``(walker, 0, offset)``, and K2 writes the accepted rows in place, with
the rows of every blob leaf (``accept_update``'s ``tree_where`` in the
JAX package, ``moves/base.py:103-126``).

The proposal function is ``proposal_function(rng, coords[, carry]) ->
(q, factors[, carry])``.  ``rng`` is the port's ``(seed, offset)`` in
the place of the JAX key; ``offset`` is a Python int, or a
:class:`~..ops.philox.DeviceOffset` (a 0-d device word plus an
increment) when the proposal is recorded into a CUDA graph, so the
function must read it only through the port's Philox helpers and never
on the host.  It may draw from :func:`~..ops.philox.normals` and
:func:`~..ops.philox.row_uniforms` (``ops/philox.py`` gives the stream
layout); word 1 at ``(walker, 0)`` is K2's.  A carry is a dict of
tensors, updated in place (a function that returns a new dict has its
values copied into the carry's tensors), so that a recorded proposal
reads and writes the same tensors at every replay.  On a CUDA device
the function runs inside K3's graphs, so it must not synchronize with
the host.

The rung axis (parallel tempering; ``emcee_tpu/parallel/tempering.py:
449-541`` vmaps the move over the ladder): the move is ``rung_batched``.
:meth:`MHMove.propose_rungs` calls the function once a rung, inside the
recorded proposal, under rung ``r``'s key (``(keys.seeds[r], offset)``),
on rung ``r``'s view of the coordinates and with a carry of views
``carry[k][r]``, and stacks the rungs' proposals into one ``(T, n, d)``
buffer; then one log-prob runs over every rung and one launch of K2's
rung kernel accepts them all at ``nsplits=1``.  Nothing in torch can vmap
a function that reads the Philox helpers with a Python seed, so a replay
costs ``T`` times the function's own kernels, where the JAX package fuses
its vmap into one program.  Rung ``r`` ends exactly as :meth:`propose` of
rung ``r`` alone under its own key would leave it.  ``GaussianMove``
proposes every rung in one launch of its kernel instead
(``moves/gaussian.py``).

Expected difference: K2 computes ``lnpdiff = (factors + lp_q) - lp``,
the JAX package ``(lp_q - lp) + factors``; with nonzero factors the two
can differ by an ulp (with the zero factors of a symmetric proposal they
are equal).
"""

from __future__ import annotations

import inspect

import torch

from ..ops import accept_kernel
from .base import Move, blob_pairs

__all__ = ["MHMove"]


class MHMove(Move):
    """General Metropolis-Hastings move.

    Args:
        proposal_function: ``(rng, coords[, carry])`` -> proposal; see
            the module docstring.
        ndim: optional dimensionality this proposal is valid for
            (reference ``mh.py:47-49``).
    """

    #: :meth:`propose_rungs` proposes every rung of a ladder at once
    rung_batched = True

    def __init__(self, proposal_function, ndim=None):
        self.ndim = ndim
        self.get_proposal = proposal_function
        try:
            nparams = len(inspect.signature(proposal_function).parameters)
        except (TypeError, ValueError):
            nparams = 2
        self._carries = nparams >= 3

    def _call(self, rng, coords, carry):
        """``(q, factors)`` of the proposal function; a new carry dict it
        returns is copied into ``carry``'s tensors."""
        if not self._carries:
            return self.get_proposal(rng, coords)
        q, factors, new_carry = self.get_proposal(rng, coords, carry)
        if isinstance(carry, dict) and new_carry is not carry:
            for k, v in new_carry.items():
                carry[k].copy_(v)
        return q, factors

    def _rung_proposals(self, rng, coords, carry):
        """``(q, factors)`` of every rung, ``(T, n, d)`` and ``(T, n)``:
        the function on each rung's view under its own key."""
        keys, offset = rng
        qs, fs = [], []
        for r, seed in enumerate(keys.seeds):
            view = ({k: v[r] for k, v in carry.items()}
                    if isinstance(carry, dict) else carry)
            q, factors = self._call((seed, offset), coords[r], view)
            qs.append(q)
            fs.append(factors.to(coords.dtype))
        return torch.stack(qs), torch.stack(fs)

    def _check_ndim(self, ndim):
        if self.ndim is not None and self.ndim != ndim:
            raise ValueError("Dimension mismatch in proposal")

    def propose(self, rng, state, model, carry, acc_count=None,
                accepted=None, log_u=None):
        """Propose every walker, evaluate, and accept through K2, in
        place.  ``log_u`` ``(nwalkers,)`` injects the accept uniforms'
        logs (the parity mode)."""
        self._check_ndim(state.coords.shape[1])
        q, factors = self._call(rng, state.coords, carry)
        accepted = self._accept(rng, state, model, q, factors, acc_count,
                                accepted, log_u)
        return state, accepted, carry

    def propose_rungs(self, rng, state, model, carry, acc_count=None,
                      accepted=None, log_u=None):
        """One proposal of every rung of a ladder: ``state``'s buffers are
        ``(T, nwalkers, ...)``, ``rng`` is ``(RungKeys, offset)``,
        ``model.compute_log_prob`` maps ``(T, n, ndim)`` rows to ``(T, n)``
        log-probs and blobs, the carry's tensors have a leading ``T`` axis,
        and ``acc_count``, ``accepted`` and ``log_u`` are ``(T,
        nwalkers)``.  Returns ``(state, accepted, carry)``."""
        if state.coords.dim() != 3:
            raise ValueError("propose_rungs takes (ntemps, nwalkers, ndim) "
                             "coordinates")
        self._check_ndim(state.coords.shape[2])
        q, factors = self._rung_proposals(rng, state.coords, carry)
        accepted = self._accept(rng, state, model, q, factors, acc_count,
                                accepted, log_u)
        return state, accepted, carry

    def _accept(self, rng, state, model, q, factors, acc_count, accepted,
                log_u):
        """The log-prob of ``q`` and K2 at ``nsplits=1`` (every rung in one
        launch on the rung axis), in place; returns ``accepted``."""
        new_lp, new_blobs = model.compute_log_prob(q)
        if accepted is None:
            accepted = torch.empty(state.coords.shape[:-1], dtype=torch.bool,
                                   device=state.coords.device)
        seed, offset = rng
        accept_kernel.accept_select(
            q.contiguous(), factors.to(state.coords.dtype).contiguous(),
            new_lp, state.coords, state.log_prob, 0, 1, accepted, acc_count,
            seed=seed, offset=offset, log_u=log_u,
            blobs=blob_pairs(new_blobs, state.blobs),
        )
        return accepted
