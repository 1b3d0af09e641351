"""Goodman & Weare (2010) walk move.

The counterpart of ``emcee_tpu/moves/walk.py:36-97``: propose ``q_i ~
N(s_i, Cov(subset of the complement))``, the subset ``s0`` complement
walkers (all of them by default).  A red-blue move, so each split's
accept/select is K2.

* **Shared covariance** (``s=None``): one covariance and one Cholesky
  factor for every walker of the split, and ``q = s + adj (z L^T)`` with
  ``z`` the walkers' normals.  K8a (``ops/dime_kernel.py``
  ``dime_moments``, ``K = 1``) reduces the complement in place into runs'
  partials, K8b's walk mode merges them and factors ``M2 / (n - 1)``
  column by column (every entry NaN where a pivot is not > 0, so every
  proposal is rejected, as with JAX's NaN Cholesky), and K18a
  (``ops/walk_kernel.py`` ``walk_propose``) draws the normals and forms
  ``q``.
* **Subset** (``s`` given): each walker's ``s0`` helpers are an exact
  subset without replacement when ``nc <= exact_subset_max`` (the ``s0``
  smallest of ``nc`` Philox keys per walker, ties by index), bootstrap
  picks otherwise, as in the JAX package.  The step is ``dz = X_c^T z /
  sqrt(s0 - 1)``, with ``X_c`` the subset centred on its mean and ``z ~
  N(0, I_s0)``: exactly ``N(0, Cov(subset))``, singular subsets
  included, with no factorisation.  This is an expected difference of
  route, not of distribution: the JAX package factors each walker's
  covariance by SVD (``multivariate_normal(method="svd")``).  K18b
  (``walk_subset``) makes the picks, the mean and the step in one launch.

The draws are the port's Philox stream (``ops/philox.py``): the normals
at ``(row, NORMAL_BLOCK | k)`` and the subset picks or keys at ``(row,
PICK_BLOCK | k)``, ``row`` the walker's row in the ensemble buffer.  The
kernels' rung axis lets :meth:`~.red_blue.RedBlueMove.propose_rungs`
propose every rung of a tempered ladder at once (each rung's factor from
its own complement, its own key and scale).
"""

from __future__ import annotations

import torch

from ..ops import dime_kernel, walk_kernel
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
    rung_batched = True

    def __init__(self, s=None, exact_subset_max=4096, **kwargs):
        self.s = s
        self.exact_subset_max = int(exact_subset_max)
        super().__init__(**kwargs)

    def get_proposal(self, rng, coords, split, model, extra=None,
                     scale=None):
        """The proposal of group ``split``.  ``extra`` injects the draws
        (the parity mode) as a dict: ``z`` the normals (``(ng, ndim)``
        shared, ``(ng, s0)`` subset) and ``picks`` ``(ng, s0)`` int64
        subset rows of the complement; on the rung axis (``coords`` ``(T,
        nwalkers, ndim)``, ``rng``'s seed a :class:`~..ops.philox.
        RungKeys`) with a leading ``T`` axis."""
        extra = extra or {}
        seed, offset = rng
        nw = coords.shape[-2]
        ng = nw // self.nsplits
        nc = nw - ng
        s0 = nc if self.s is None else int(self.s)
        if s0 >= nc:
            part = dime_kernel.dime_moments(coords, (split * ng, ng), None,
                                            None, 1)
            chol = dime_kernel.dime_finish(part, mode="walk")
            return walk_kernel.walk_propose(coords, split, self.nsplits, chol,
                                            seed, offset, scale,
                                            extra.get("z"))
        return walk_kernel.walk_subset(
            coords, split, self.nsplits, s0, self.exact_subset_max, seed,
            offset, scale, extra.get("z"), extra.get("picks"))
