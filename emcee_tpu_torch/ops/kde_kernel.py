"""K7: the KDE log-density of ``KDEMove``, as a CUDA kernel and as plain
PyTorch.

Held against ``emcee_tpu/moves/kde.py:89-106`` (``KDEMove._logpdf``): the
log-density of rows ``x`` under Gaussian kernels at the rows ``c`` with the
kernel covariance's lower Cholesky factor ``L``.  The JAX package whitens
both sets, forms the ``ns x nc`` squared distances ``|x'|^2 + |c'|^2 - 2
x' c'^T`` with one matmul and reduces each row with a logsumexp; XLA
writes that matrix.  Here the whitening stays a ``torch.linalg.
solve_triangular`` in the caller (``moves/kde.py``), and this module takes
the whitened rows ``x'`` and kernels ``c'`` and a device scalar ``lognorm
= log nc + (nd / 2) log(2 pi) + sum log diag L``, and returns ``logsumexp_j
(-((|x'_i|^2 + |c'_j|^2) - 2 x'_i . c'_j) / 2) - lognorm`` with no matrix.

* **The kernel** (:func:`kde_logpdf`, ``csrc/kde_logpdf.cu``): a warp owns
  a few rows; lane ``l`` takes the kernels ``j = l (mod 32)`` in order and
  keeps a running ``(max, sum)`` pair per row; the lanes merge by a fixed
  butterfly (xor 16, 8, 4, 2, 1).  The complement is staged through
  shared memory in tiles.
* **The plain version** (:func:`kde_logpdf_plain`): the same steps over
  ``ceil(nc / 32)`` column groups, vectorised over rows and lanes, and
  the same butterfly.  Every sum runs from +0.0 in column order, every
  operation rounds once, so on the card the two agree bit for bit
  (``torch.exp`` / ``torch.log`` are libdevice's ``expf`` / ``logf``
  there); on the CPU ``torch.exp`` is another implementation, and the
  tests hold the plain version to the JAX package and to float64.

Both take ``(n, nd)`` rows or, on the rung axis (parallel tempering:
``emcee_tpu/parallel/tempering.py:538`` vmaps ``KDEMove`` over the
ladder), ``(T, n, nd)`` rows, ``(T, nc, nd)`` kernels and a ``(T,)``
``lognorm``: every rung in one launch.  Each row's value depends on its
own rung's kernels only, never on the rows it is evaluated with, so ``s``
and ``q`` of a split go through one launch stacked.

What bounds it on an H100: operations (the bytes are the inputs, once).
At ``KDEMove``'s shape (``ns = nc = 5e4``, nd 5; ``s`` and ``q`` stacked,
5e9 pairs) the least time is ~1.3 ms by the float32 and special-function
rates; the design keeps every pair's work in registers and never writes
the 10 GB matrix.

:func:`kde_logpdf` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; it never falls back from one to the other,
and counts its launches in ``kde_logpdf.launches`` (and in
``kde_logpdf.device_launches``, when set, on the card:
``_wrap.count_launches``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ._wrap import check_f32, count_launches, device_sm_count, launch

__all__ = ["KDEPlan", "KDE_ROWS_MAX", "KDE_TILE", "KDE_WARPS", "kde_logpdf",
           "kde_logpdf_plain", "kde_plan", "kde_smem"]

#: rows a warp at most (kRowsMax in csrc/kde_logpdf.cu)
KDE_ROWS_MAX = 8
#: warps a block of the plan
KDE_WARPS = 4
#: kernels staged in shared memory at a time (a multiple of 32)
KDE_TILE = 256
#: the plan's blocks fill the card this many times over where the rows
#: allow it
KDE_BLOCKS_PER_SM = 2
#: dynamic shared memory a plan may take (above 48 KB the kernel opts in
#: by its function attribute; an H100 block may use 227 KB)
KDE_SMEM_MAX = 100 * 1024
#: ndims whose rows and kernels the kernel keeps in registers (kNd)
KDE_REG_ND = 8


class KDEPlan(NamedTuple):
    """How K7 is launched: the C entry point's plan arguments."""

    rows: int  #: rows a warp, 1 to ``KDE_ROWS_MAX``
    warps: int  #: warps a block
    tile: int  #: kernels staged at a time, a multiple of 32
    smem: int  #: dynamic shared memory a block, bytes


def kde_smem(nd, rows, warps, tile):
    """Dynamic shared memory of a block: ``tile`` kernels at an odd row
    stride (``nd | 1``) and their squared norms, and above ``KDE_REG_ND``
    the block's rows."""
    floats = tile * ((nd | 1) + 1)
    if nd > KDE_REG_ND:
        floats += warps * rows * nd
    return 4 * floats


def kde_plan(n, nd, n_sm, rungs=1):
    """K7's launch plan for ``rungs`` rungs of ``n`` rows of ``nd``
    floats on a card of ``n_sm`` SMs: blocks of ``KDE_WARPS`` warps, each
    warp the most rows (8, 4, 2, 1) that still give every rung's blocks
    together ``KDE_BLOCKS_PER_SM`` blocks for every SM (a warp's rows share
    each kernel's load from shared memory; more, smaller warps spread a
    small ladder over the card); tiles of ``KDE_TILE`` kernels, halved
    while the block's shared memory exceeds ``KDE_SMEM_MAX``."""
    warps, rows = KDE_WARPS, KDE_ROWS_MAX
    while rows > 1 and rungs * -(-n // (warps * rows)) < (
            KDE_BLOCKS_PER_SM * n_sm):
        rows //= 2
    tile = KDE_TILE
    while tile > 32 and kde_smem(nd, rows, warps, tile) > KDE_SMEM_MAX:
        tile //= 2
    return KDEPlan(rows, warps, tile, kde_smem(nd, rows, warps, tile))


def _sums(t):
    """``sum_k t_k t_k`` over the last axis, from +0.0 in column order
    (the kernel's)."""
    acc = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
    for k in range(t.shape[-1]):
        acc = acc + t[..., k] * t[..., k]
    return acc


def _lse_add(m, s, a):
    """The running logsumexp step of the kernel, elementwise."""
    d = a - m
    big = d > 0
    e = torch.exp(torch.where(big, -d, d))
    return torch.where(big, a, m), torch.where(big, s * e + 1.0, s + e)


def _lse_merge(m, s, mb, sb):
    """The butterfly's merge of a partner's pair into a lane's own."""
    mm = torch.where(mb > m, mb, m)
    return mm, s * torch.exp(m - mm) + sb * torch.exp(mb - mm)


def _rows_plain(x, c, c2, lognorm):
    """The plain version on one block of rows ``x`` (``(..., n, nd)``)."""
    nc = c.shape[-2]
    x2 = _sums(x)[..., None]
    lead = x.shape[:-1] + (32,)
    m = torch.full(lead, -torch.finfo(x.dtype).max, dtype=x.dtype,
                   device=x.device)
    s = torch.zeros(lead, dtype=x.dtype, device=x.device)
    for j0 in range(0, nc, 32):
        lanes = min(32, nc - j0)
        cj = c[..., None, j0:j0 + lanes, :]
        dot = torch.zeros(x.shape[:-1] + (lanes,), dtype=x.dtype,
                          device=x.device)
        for k in range(x.shape[-1]):
            dot = dot + x[..., :, None, k] * cj[..., k]
        a = -0.5 * ((x2 + c2[..., None, j0:j0 + lanes]) - 2.0 * dot)
        if lanes == 32:
            m, s = _lse_add(m, s, a)
        else:  # the lanes past nc add nothing
            mv, sv = _lse_add(m[..., :lanes], s[..., :lanes], a)
            m = torch.cat((mv, m[..., lanes:]), dim=-1)
            s = torch.cat((sv, s[..., lanes:]), dim=-1)
    lane = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        m, s = _lse_merge(m, s, m[..., lane ^ o], s[..., lane ^ o])
    return (m[..., 0] + torch.log(s[..., 0])) - lognorm[..., None]


def kde_logpdf_plain(x, c, lognorm, rows=None):
    """Plain PyTorch K7: ``(n,)`` log-densities of the whitened rows ``x``
    ``(n, nd)`` under the whitened kernels ``c`` ``(nc, nd)``, ``lognorm``
    a 0-d tensor (``(T, n)`` of ``(T, n, nd)`` rows, ``(T, nc, nd)``
    kernels and a ``(T,)`` ``lognorm``).  ``rows`` bounds the rows a pass
    (its ``(rows, 32)`` lane arrays); each row's value is the same in any
    pass."""
    c2 = _sums(c)
    n = x.shape[-2]
    rows = n if rows is None else max(1, int(rows))
    if rows >= n:
        return _rows_plain(x, c, c2, lognorm)
    return torch.cat([_rows_plain(x[..., lo:lo + rows, :], c, c2, lognorm)
                      for lo in range(0, n, rows)], dim=-1)


def kde_logpdf(x, c, lognorm, rows=None):
    """K7 on the rows' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (``rows``, the plain version's rows a pass,
    means nothing to the kernel, which holds no matrix).  ``x`` ``(n,
    nd)`` or ``(T, n, nd)`` float32 whitened rows, ``c`` ``(nc, nd)`` or
    ``(T, nc, nd)`` whitened kernels, ``lognorm`` ``()`` or ``(T,)``.
    Returns the ``(n,)`` or ``(T, n)`` log-densities."""
    dev = x.device
    if dev.type == "cpu":
        return kde_logpdf_plain(x, c, lognorm, rows)
    if dev.type != "cuda":
        raise ValueError(f"no K7 kernel for device {dev}")
    if x.dim() not in (2, 3) or c.dim() != x.dim():
        raise ValueError("x and c must be (n, nd) and (nc, nd), or (T, n, "
                         "nd) and (T, nc, nd)")
    lead = tuple(int(t) for t in x.shape[:-2])
    ntemps = lead[0] if lead else 1
    n, nd = (int(t) for t in x.shape[-2:])
    nc = int(c.shape[-2])
    if not 1 <= ntemps < 65536 or nd < 1:
        raise ValueError(f"bad K7 shape {tuple(x.shape)}")
    if max(ntemps * n * nd, ntemps * nc * nd) >= 2**31:
        raise ValueError("rows too many for int32 indexing")
    check_f32("x", x, dev)
    check_f32("c", c, dev, lead + (nc, nd))
    check_f32("lognorm", lognorm, dev, lead)
    out = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    if n:
        _launch(kde_plan(n, nd, device_sm_count(dev), ntemps), dev, x, c,
                lognorm, out, n, nc, nd, ntemps)
        count_launches(kde_logpdf)
    return out


kde_logpdf.launches = 0
kde_logpdf.device_launches = None


def _launch(plan, device, x, c, lognorm, out, n, nc, nd, ntemps):
    """Launch K7 with launch plan ``plan`` on checked arguments."""
    if not (1 <= plan.rows <= KDE_ROWS_MAX and 1 <= plan.warps <= 8
            and plan.tile >= 32 and plan.tile % 32 == 0
            and plan.smem == kde_smem(nd, plan.rows, plan.warps, plan.tile)
            and plan.smem <= 227 * 1024):
        raise ValueError(f"bad K7 plan {plan}")
    launch("kde_logpdf", device, x.data_ptr(), c.data_ptr(),
           lognorm.data_ptr(), out.data_ptr(), n, nc, nd, ntemps, *plan)

