"""Goodman & Weare (2010) walk move.

The counterpart of ``emcee_tpu/moves/walk.py:36-97``: propose ``q_i ~
N(s_i, Cov(subset of the complement))``, the subset ``s0`` complement
walkers (all of them by default).  A red-blue move, so each split's
accept/select is K2.

* **Shared covariance** (``s=None``): one covariance and one Cholesky
  factor for every walker of the split, and ``q = s + (z @ L^T)`` with
  ``z`` the walkers' normals.  The factor is ``torch.linalg.cholesky_ex``,
  which reports failure in a tensor instead of checking on the host (a
  recorded proposal cannot sync); a covariance that is not positive
  definite gives a NaN factor, so every proposal is rejected, as with
  JAX's NaN Cholesky.
* **Subset** (``s`` given): each walker's ``s0`` helpers are an exact
  subset without replacement when ``nc <= exact_subset_max`` (a stable
  argsort of ``nc`` Philox keys per walker), bootstrap picks otherwise,
  as in the JAX package.  The step is ``dz = X_c^T z / sqrt(s0 - 1)``,
  with ``X_c`` the subset centred on its mean and ``z ~ N(0, I_s0)``:
  exactly ``N(0, Cov(subset))``, singular subsets included, with no
  factorisation.  This is an expected difference of route, not of
  distribution: the JAX package factors each walker's covariance by SVD
  (``multivariate_normal(method="svd")``), and ``torch.linalg.svd`` and
  ``eigh`` check on the host.

The draws are the port's Philox stream (``ops/philox.py``): the normals
at ``(row, NORMAL_BLOCK | k)`` and the subset picks or keys at ``(row,
PICK_BLOCK | k)``, ``row`` the walker's row in the ensemble buffer.
"""

from __future__ import annotations

import math

import torch

from ..ops.philox import normals, row_uniforms
from .red_blue import RedBlueMove

__all__ = ["WalkMove", "cholesky_or_nan", "complement", "cov"]


def complement(coords, split, ng):
    """The rows of every split but ``split``, in row order (the order of
    ``jnp.concatenate(c_parts)`` in the JAX package); the walker axis is
    the one before the last, so ``(T, nwalkers, ndim)`` rungs give each
    rung's complement."""
    lo = split * ng
    return torch.cat((coords[..., :lo, :], coords[..., lo + ng:, :]),
                     dim=-2)


def cov(x):
    """``np.cov(x, rowvar=False)``: ``(n, d) -> (d, d)``, ddof 1; of each
    ``(n, d)`` of a batch ``(..., n, d)`` (a rung's complement on the rung
    axis) by one batched product, which may round otherwise than each
    matrix's own."""
    xc = x - x.mean(dim=-2, keepdim=True)
    return (xc.mT @ xc) / (x.shape[-2] - 1)


def cholesky_or_nan(a):
    """The lower Cholesky factor of ``a`` (of each matrix of a batch), NaN
    where it does not exist, with no host sync (``torch.linalg.cholesky``
    checks on the host)."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], chol, torch.nan)


class WalkMove(RedBlueMove):
    """The ensemble walk move.

    Args:
        s: number of helper walkers; default uses the whole complement.
        exact_subset_max: complement size up to which each walker's
            subset is drawn exactly without replacement; above it the
            subset is bootstrap draws with replacement (an O(ng * s) cost
            instead of O(ng * nc); the proposal stays symmetric given the
            complement).
    """

    tunable = True

    def __init__(self, s=None, exact_subset_max=4096, **kwargs):
        self.s = s
        self.exact_subset_max = int(exact_subset_max)
        super().__init__(**kwargs)

    def get_proposal(self, rng, coords, split, model, extra=None,
                     scale=None):
        """The proposal of group ``split``.  ``extra`` injects the draws
        (the parity mode) as a dict: ``z`` the normals (``(ng, ndim)``
        shared, ``(ng, s0)`` subset) and ``picks`` ``(ng, s0)`` int64
        subset rows of the complement."""
        extra = extra or {}
        seed, offset = rng
        nw, nd = coords.shape
        ng = nw // self.nsplits
        nc = nw - ng
        s = coords[split * ng:(split + 1) * ng]
        c = complement(coords, split, ng)
        s0 = nc if self.s is None else int(self.s)
        adj = 1.0 if scale is None else scale
        dev, dt = coords.device, coords.dtype
        row0 = split * ng
        if s0 >= nc:
            z = extra.get("z")
            if z is None:
                z = normals(ng, nd, seed, offset, dev, dt, row0=row0)
            q = s + adj * (z @ cholesky_or_nan(cov(c)).T)
            return q, torch.zeros(ng, dtype=dt, device=dev)
        picks = extra.get("picks")
        if picks is None:
            if nc <= self.exact_subset_max:
                keys = row_uniforms(ng, nc, seed, offset, dev, row0=row0)
                picks = torch.argsort(keys, dim=1, stable=True)[:, :s0]
            else:
                u = row_uniforms(ng, s0, seed, offset, dev, row0=row0)
                picks = torch.clamp((u * nc).to(torch.int64), max=nc - 1)
        sub = c[picks]  # (ng, s0, nd)
        xc = sub - sub.mean(dim=1, keepdim=True)
        z = extra.get("z")
        if z is None:
            z = normals(ng, s0, seed, offset, dev, dt, row0=row0)
        dz = torch.einsum("gs,gsd->gd", z, xc) / math.sqrt(s0 - 1)
        return s + adj * dz, torch.zeros(ng, dtype=dt, device=dev)
