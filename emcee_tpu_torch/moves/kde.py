"""Gaussian-KDE ensemble move.

The counterpart of ``emcee_tpu/moves/kde.py:31-106``: fit a Gaussian
kernel density estimate to the complement (bandwidth factor by Scott's
rule, Silverman's or a number, the kernel covariance ``factor^2 *
Cov(complement)`` as ``scipy.stats.gaussian_kde`` computes it), resample
the proposals from it (a random kernel centre plus correlated noise
through the kernel's Cholesky factor), and take ``logpdf(s) -
logpdf(q)`` as the Hastings factor.  A red-blue move, so each split's
accept/select is K2.  ``max_complement`` subsamples the complement
without replacement (a stable argsort of Philox keys), fresh each
proposal.

K7, the log-density :func:`kde_logpdf`, is a hand-written kernel
(``ops/kde_kernel.py``, ``csrc/kde_logpdf.cu``): triangular solves
(``torch.linalg.solve_triangular``) whiten the rows and the kernels here,
and the kernel reduces each row over the kernels with a running
logsumexp, never forming the ``ns x nc`` distance matrix (a proposal of
1e5 walkers is a 5e4 x 5e4 pair space a split).  ``s`` and ``q`` of a
split are whitened apart and evaluated in one launch, stacked; a row's
value does not depend on the rows beside it.

The draws are the port's Philox stream (``ops/philox.py``): the kernel
centre from word 0 at ``(i, split)``, the noise's normals at ``(row,
NORMAL_BLOCK | k)``, the subsample's keys at ``(j, SUBSAMPLE_BLOCK |
split)``.  Cholesky factors come from ``torch.linalg.cholesky_ex`` (NaN
where the covariance is not positive definite, and then NaN
log-densities; no host sync).

The rung axis (parallel tempering: ``emcee_tpu/parallel/tempering.py:538``
vmaps the move over the ladder): the move is ``rung_batched``, so
:meth:`~.red_blue.RedBlueMove.propose_rungs` proposes every rung at once
on ``(T, nwalkers, ndim)`` buffers under the rungs' keys (a
:class:`~..ops.philox.RungKeys`): each rung's draws are its one-ensemble
draws under its own key, its complement's covariance and Cholesky factor
one batched product and ``cholesky_ex``, its proposal one batched product
by ``L``, and K7 one launch for every rung's ``s`` and ``q``.  The batched
products may round otherwise than each rung's own (``ROADMAP.md`` section
3).
"""

from __future__ import annotations

import math

import torch

from ..ops import kde_kernel
from ..ops.philox import (
    SUBSAMPLE_BLOCK, normals, rung_words, walker_words, word_uniforms)
from .red_blue import RedBlueMove
from .walk import cholesky_or_nan, complement, cov

__all__ = ["KDEMove", "kde_logpdf"]


def _whiten(x, chol):
    """``L^-1 x`` of every row of ``x`` (``(..., n, nd)``), contiguous."""
    return torch.linalg.solve_triangular(
        chol, x.mT, upper=False).mT.contiguous()


def _logpdfs(xs, c, chol, block_bytes=None):
    """The log-densities of each row set of ``xs`` under the kernels ``c``
    and factor ``chol`` (each ``(..., n, nd)``, ``(..., nc, nd)`` and
    ``(..., nd, nd)``), from one K7 launch: each set whitened on its own,
    the sets stacked.  ``block_bytes`` bounds the plain version's pass to
    ``block_bytes / (4 nc)`` rows."""
    nc, nd = c.shape[-2:]
    lognorm = (math.log(nc) + 0.5 * nd * math.log(2.0 * math.pi)
               + torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1))
    rows = (None if block_bytes is None
            else max(1, block_bytes // (nc * c.element_size())))
    xw = torch.cat([_whiten(x, chol) for x in xs], dim=-2)
    out = kde_kernel.kde_logpdf(xw, _whiten(c, chol), lognorm, rows)
    return out.split([x.shape[-2] for x in xs], dim=-1)


def kde_logpdf(x, c, chol, block_bytes=None):
    """The log-density of the rows of ``x`` under Gaussian kernels at the
    rows of ``c`` with the kernel covariance's lower Cholesky factor
    ``chol`` (``emcee_tpu/moves/kde.py:89-106``): ``logsumexp_j(-|L^-1
    (x - c_j)|^2 / 2) - log(nc) - nd/2 log(2 pi) - log|L|``, the squared
    distance as ``(|x'|^2 + |c'|^2) - 2 x' c'_j`` of the whitened rows (K7).
    On the rung axis ``(T, n, nd)`` rows, ``(T, nc, nd)`` kernels and
    ``(T, nd, nd)`` factors give ``(T, n)``.  ``block_bytes`` bounds the
    rows a pass of K7's plain version (the CPU's); the kernel holds no
    matrix."""
    return _logpdfs((x,), c, chol, block_bytes)[0]


def _take(c, idx):
    """Rows ``idx`` of ``c`` (``(..., n)`` indices into ``(..., nc, nd)``)."""
    return torch.take_along_dim(c, idx[..., None], dim=-2)


class KDEMove(RedBlueMove):
    """Proposal from a Gaussian KDE of the complementary ensemble.

    Args:
        bw_method: ``None`` or ``"scott"``, ``"silverman"``, or a number:
            the bandwidth factor (as ``scipy.stats.gaussian_kde``).
        max_complement: optional cap on the complement walkers the KDE
            uses.
    """

    rung_batched = True

    def __init__(self, bw_method=None, max_complement=None, **kwargs):
        self.bw_method = bw_method
        self.max_complement = max_complement
        super().__init__(**kwargs)

    def _factor(self, nc, d):
        if self.bw_method is None or self.bw_method == "scott":
            return nc ** (-1.0 / (d + 4))
        if self.bw_method == "silverman":
            return (nc * (d + 2) / 4.0) ** (-1.0 / (d + 4))
        return float(self.bw_method)

    def get_proposal(self, rng, coords, split, model, extra=None,
                     scale=None):
        """The proposal of group ``split``.  ``extra`` injects the draws
        (the parity mode) as a dict: ``pick`` ``(ng,)`` int64 kernel
        centres and ``noise`` ``(ng, ndim)`` normals (and ``sub``, the
        subsample's complement rows, with ``max_complement``).  On the rung
        axis (``coords`` ``(T, nwalkers, ndim)``, ``rng``'s seed a
        :class:`~..ops.philox.RungKeys`) every rung's group at once, and
        each injected draw has a leading ``T`` axis."""
        extra = extra or {}
        seed, offset = rng
        nw, nd = coords.shape[-2:]
        ng = nw // self.nsplits
        dev, dt = coords.device, coords.dtype
        s = coords[..., split * ng:(split + 1) * ng, :]
        c = complement(coords, split, ng)
        if (self.max_complement is not None
                and c.shape[-2] > self.max_complement):
            sub = extra.get("sub")
            if sub is None:
                block = SUBSAMPLE_BLOCK | split
                if coords.dim() == 3:
                    keys = rung_words(seed, c.shape[-2], block, offset, dev,
                                      word=0)
                else:
                    keys = walker_words(c.shape[0], block, seed, offset, dev,
                                        word=0)
                sub = torch.argsort(keys, dim=-1,
                                    stable=True)[..., :self.max_complement]
            c = _take(c, sub)
        nc = c.shape[-2]
        chol = cholesky_or_nan(self._factor(nc, nd) ** 2 * cov(c))
        pick = extra.get("pick")
        if pick is None:
            u = word_uniforms(ng, 1, split, seed, offset, dev)[..., 0]
            pick = torch.clamp((u * nc).to(torch.int64), max=nc - 1)
        noise = extra.get("noise")
        if noise is None:
            noise = normals(ng, nd, seed, offset, dev, dt, row0=split * ng)
        q = _take(c, pick) + noise @ chol.mT
        lp_s, lp_q = _logpdfs((s, q), c, chol)
        return q, lp_s - lp_q
