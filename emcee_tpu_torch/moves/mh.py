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

    def __init__(self, proposal_function, ndim=None):
        self.ndim = ndim
        self.get_proposal = proposal_function
        try:
            nparams = len(inspect.signature(proposal_function).parameters)
        except (TypeError, ValueError):
            nparams = 2
        self._carries = nparams >= 3

    def propose(self, rng, state, model, carry, acc_count=None,
                accepted=None, log_u=None):
        """Propose every walker, evaluate, and accept through K2, in
        place.  ``log_u`` ``(nwalkers,)`` injects the accept uniforms'
        logs (the parity mode)."""
        nwalkers, ndim = state.coords.shape
        if self.ndim is not None and self.ndim != ndim:
            raise ValueError("Dimension mismatch in proposal")
        if self._carries:
            q, factors, new_carry = self.get_proposal(rng, state.coords,
                                                      carry)
            if isinstance(carry, dict) and new_carry is not carry:
                for k, v in new_carry.items():
                    carry[k].copy_(v)
        else:
            q, factors = self.get_proposal(rng, state.coords)
        new_lp, new_blobs = model.compute_log_prob(q)
        if accepted is None:
            accepted = torch.empty(nwalkers, dtype=torch.bool,
                                   device=state.coords.device)
        seed, offset = rng
        accept_kernel.accept_select(
            q.contiguous(), factors.to(state.coords.dtype).contiguous(),
            new_lp, state.coords, state.log_prob, 0, 1, accepted, acc_count,
            seed=seed, offset=offset, log_u=log_u,
            blobs=blob_pairs(new_blobs, state.blobs),
        )
        return state, accepted, carry
