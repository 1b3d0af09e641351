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

K7, the log-density :func:`kde_logpdf`, is plain torch: triangular
solves (``torch.linalg.solve_triangular``) whiten both sets, one
``torch.matmul`` forms the cross term of the squared distances, and
``torch.logsumexp`` reduces over the kernels.  Its ``ns x nc`` matrix is
formed in blocks of rows of ``x`` (``LOGPDF_BLOCK_BYTES`` each), so a
proposal of 1e5 walkers (a 5e4 x 5e4 float32 matrix, 10 GB, twice per
split) holds one block at a time inside a recorded graph.  A row's
log-density is one ``logsumexp`` over all of its kernels in any block;
only the matmul may round otherwise for another block shape.

The draws are the port's Philox stream (``ops/philox.py``): the kernel
centre from word 0 at ``(i, split)``, the noise's normals at ``(row,
NORMAL_BLOCK | k)``, the subsample's keys at ``(j, SUBSAMPLE_BLOCK |
split)``.  Cholesky factors come from ``torch.linalg.cholesky_ex`` (NaN
where the covariance is not positive definite; no host sync).
"""

from __future__ import annotations

import math

import torch

from ..ops.philox import (
    SUBSAMPLE_BLOCK, normals, to_uniform, walker_words)
from .red_blue import RedBlueMove
from .walk import cholesky_or_nan, complement, cov

__all__ = ["LOGPDF_BLOCK_BYTES", "KDEMove", "kde_logpdf"]

#: bytes of one block of :func:`kde_logpdf`'s distance matrix
LOGPDF_BLOCK_BYTES = 256 << 20


def kde_logpdf(x, c, chol, block_bytes=LOGPDF_BLOCK_BYTES):
    """The log-density of the rows of ``x`` under Gaussian kernels at the
    rows of ``c`` with the kernel covariance's lower Cholesky factor
    ``chol`` (``emcee_tpu/moves/kde.py:88-106``): ``logsumexp_j(-|L^-1
    (x - c_j)|^2 / 2) - log(nc) - nd/2 log(2 pi) - log|L|``, the squared
    distance as ``|x'|^2 + |c'|^2 - 2 x' c'^T`` of the whitened rows."""
    n, nd = x.shape
    nc = c.shape[0]
    xw = torch.linalg.solve_triangular(chol, x.T, upper=False).T
    cw = torch.linalg.solve_triangular(chol, c.T, upper=False).T
    x2 = (xw**2).sum(dim=1, keepdim=True)
    c2 = (cw**2).sum(dim=1)[None, :]
    lognorm = (math.log(nc) + 0.5 * nd * math.log(2.0 * math.pi)
               + torch.log(torch.diagonal(chol)).sum())
    rows = max(1, block_bytes // (nc * x.element_size()))
    out = []
    for lo in range(0, n, rows):
        d2 = x2[lo:lo + rows] + c2 - 2.0 * (xw[lo:lo + rows] @ cw.T)
        out.append(torch.logsumexp(-0.5 * d2, dim=1))
    return torch.cat(out) - lognorm


class KDEMove(RedBlueMove):
    """Proposal from a Gaussian KDE of the complementary ensemble.

    Args:
        bw_method: ``None`` or ``"scott"``, ``"silverman"``, or a number:
            the bandwidth factor (as ``scipy.stats.gaussian_kde``).
        max_complement: optional cap on the complement walkers the KDE
            uses.
    """

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
        subsample's complement rows, with ``max_complement``)."""
        extra = extra or {}
        seed, offset = rng
        nw, nd = coords.shape
        ng = nw // self.nsplits
        dev, dt = coords.device, coords.dtype
        s = coords[split * ng:(split + 1) * ng]
        c = complement(coords, split, ng)
        if self.max_complement is not None and c.shape[0] > self.max_complement:
            sub = extra.get("sub")
            if sub is None:
                keys = walker_words(c.shape[0], SUBSAMPLE_BLOCK | split, seed,
                                    offset, dev)[0]
                sub = torch.argsort(keys, stable=True)[:self.max_complement]
            c = c[sub]
        nc = c.shape[0]
        chol = cholesky_or_nan(self._factor(nc, nd) ** 2 * cov(c))
        pick = extra.get("pick")
        if pick is None:
            u = to_uniform(walker_words(ng, split, seed, offset, dev)[0])
            pick = torch.clamp((u * nc).to(torch.int64), max=nc - 1)
        noise = extra.get("noise")
        if noise is None:
            noise = normals(ng, nd, seed, offset, dev, dt, row0=split * ng)
        q = c[pick] + noise @ chol.T
        return q, kde_logpdf(s, c, chol) - kde_logpdf(q, c, chol)
