"""K8: DIME's moments, factor and proposal, as CUDA kernels and as plain
PyTorch.

Held against ``emcee_tpu/moves/dime.py``: the complement's centered
moments (``_centered_moments``, ``:38-47``; with ``n_components = K > 1``
the nearest-mean hard assignment and per-component moments of
``_assign_means`` / ``_masked_moments``, ``:180-231``), their pooling with
the decayed history (``_pooled`` / ``_pooled_k``, ``:133-146``,
``:233-251``), the t-shape's Cholesky factor, its inverse, the
log-weights and log-determinants (``_t_shape_chol``,
``_mixture_quantities``, ``:148-155``, ``:253-276``), the proposal and its
Hastings factor (``get_proposal`` / ``_get_proposal_mixture``,
``:298-431``) and the carry update (``update_carry``, ``:433-468``).  The
JAX package leaves that chain to XLA; the port had it as plain torch with
cuBLAS products and a cuSOLVER factor.  Three kernels take its place:

* **K8a** :func:`dime_moments` (``csrc/dime_moments.cu``): a split
  reduction over the rows of a set, a split's complement read in place as
  two row ranges (``skip``: the split's own rows) or the whole ensemble.
  Block ``b`` takes rows ``[b R, (b + 1) R)`` of the set (``R`` =
  :data:`DIME_ROWS`, the plan's ``rows``); with ``K > 1`` every row goes
  to its nearest assignment mean (``|x - mu|^2`` summed in column order;
  the carry's means, or at the cold start, ``sum w == 0``, the strided
  rows ``(k * max(1, n // K)) % n`` of the set) and the block writes, per
  component, its count, its mean (its first member's row plus the
  members' offsets from it, summed in row order, over the count; 0 for
  none) and the cross-products centered on that mean (summed in row
  order).  No ``E[xx^T] - mu mu^T`` anywhere, and no sum of rows far from
  0: at ``|mu| >> sigma`` the summands stay of the spread's size.
* **K8b** :func:`dime_finish`: one block a rung.  It merges the partials
  by a pairwise tree (level ``s``: node ``p`` takes node ``p + s`` for
  ``p = 0, 2s, 4s, ...``) with Chan's combine, pools the result with the
  carry, and then either writes the carry in place (``mode="update"``,
  the carry update) or writes a table for K8c: the t-shape ``cov * (df - 2) /
  df + eps I`` factored column by column (every entry NaN where a pivot
  is not > 0, as ``cholesky_ex`` with ``info != 0``), its inverse row by
  row, the log-determinants, the log-weights and their running sum.  Its
  walk mode (``mode="walk"``, ``K = 1``) is the walk move's shared factor
  (``emcee_tpu/moves/walk.py:29-33, 73-79``): the tree, then ``M2 / (n -
  1)`` factored column by column into ``(..., nd, nd)``, nothing pooled.
* **K8c** :func:`dime_propose`: one thread a walker.  It draws at the
  port's counters (normals at ``(row, NORMAL_BLOCK | k)``, the DE jitter
  after them, four uniforms at ``(row, DIME_BLOCK)``, the chi-square at
  ``(row, CHI2_BLOCK | k)``: :func:`chi_square`), picks the component by
  the inverse of the weights' running sum, forms ``q_t = mean + L z
  sqrt(df / chi2)`` (or the DE step) and both Mahalanobis forms under
  ``L^-1`` (or the mixture's logsumexp), and writes ``q`` and the factor.

Every sum runs from +0.0 in a fixed order and every operation rounds once,
so on the card each kernel equals its plain version bit for bit (the plain
versions divide only by tensors: torch turns a division by a Python
number into a product by its reciprocal on the card).  On the CPU the
plain versions are the move's route, held to the JAX package within
float32 rounding.

On the rung axis (parallel tempering: ``emcee_tpu/parallel/tempering.py:
449-541`` vmaps DIME over the ladder) ``x`` is ``(T, nw, nd)``, the carry
tensors have a leading ``T`` axis and ``seed`` is the rungs'
:class:`~.philox.RungKeys`: every rung in one launch of each kernel, each
rung computed as alone.

What bounds them on an H100: the bytes (the rows once, about 1 MB of a
split's complement at 1e5 x 5); the reductions are short serial chains
that the many blocks overlap, and the factor is a few microseconds of one
block.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; it never falls back, and counts its launches in
``<wrapper>.launches`` (and ``<wrapper>.device_launches`` when set:
``_wrap.count_launches``).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ._wrap import check_f32, count_launches, key_args, launch
from ._wrap import ptr, rng_args
from .philox import CHI2_BLOCK, DIME_BLOCK, box_muller, normals, row_uniforms
from .philox import row_words, to_uniform

__all__ = ["DIME_ROWS", "DIME_ROWS_MAX", "DimeConfig", "DimePlan",
           "FINISH_MODES", "MT_CANDIDATES", "chi_square", "chol_columns_plain",
           "dime_finish", "dime_finish_plain",
           "dime_moments", "dime_moments_plain", "dime_plan",
           "dime_propose", "dime_propose_plain", "logq_plain",
           "masked_moments_plain", "pool_plain", "table_size",
           "t_shape_chol_plain", "unpack_table"]

#: rows a run of K8a (the leaves of the partials' tree: the one plan
#: parameter that sets the bits).  On the H100, at the DIME stage's shape,
#: runs of 128 in blocks of 8 gave the least K8a + K8b time of runs of
#: 64-256 in blocks of 1-8 (chip_smoke.py k8_plan_sweep, PERF.md)
DIME_ROWS = 128
#: the largest run (kRowsMax in csrc/dime_moments.cu)
DIME_ROWS_MAX = 1024
#: the most runs a K8a block merges (kGroupMax)
DIME_GROUP_MAX = 8
#: the shared memory a block of grouped runs may take (the group is halved
#: until it fits)
DIME_GROUP_SMEM = 64 * 1024
#: the dynamic shared memory a K8a or K8b block may take (kSharedMax in
#: csrc/dime_moments.cu; above 48 KB by the kernel's opt-in)
DIME_SMEM_MAX = 160 * 1024
#: threads of a K8a block, of K8b's one block a rung, of a K8c block
MOMENT_THREADS = 256
FINISH_THREADS = 256
PROPOSE_THREADS = 128
#: Marsaglia-Tsang candidates per walker for a chi-square of non-integer
#: ``df``: a candidate is refused with probability below 0.049 at any
#: shape ``df / 2 > 1``, so a walker exhausts 10 with probability below
#: 0.049**10 < 1e-12
MT_CANDIDATES = 10
#: K8b's modes -> the kernel's code (``kTable``, ``kUpdate``, ``kWalk`` in
#: ``csrc/dime_moments.cu``)
FINISH_MODES = {"table": 0, "update": 1, "walk": 2}


class DimePlan(NamedTuple):
    """How K8a cuts a set of rows."""

    rows: int  #: rows a run (sets the leaves of the tree)
    group: int  #: runs a K8a block, merged there (a power of two)
    blocks: int  #: K8a blocks a rung, ``ceil(n / (rows group))``: the partials


class DimeConfig(NamedTuple):
    """A ``DIMEMove``'s constants as K8 takes them."""

    components: int
    rho: float
    df: float | None
    aimh_prob: float
    gamma0: float  #: the DE stretch as float32 (``de_kernel.de_gamma0``)
    sigma: float
    #: Marsaglia-Tsang candidates a walker (non-integer ``df``)
    candidates: int = 10


def dime_plan(n, nd, components=1, rows=None):
    """K8a's plan for a set of ``n`` rows of ``nd`` floats with
    ``components`` components.  A run is :data:`DIME_ROWS` (or ``rows``)
    rows whatever the card and the ladder, so that a rung's bits never
    depend on either; a block merges :func:`moments_group` runs by the
    tree's first levels, which leaves the bits as they are and takes K8b's
    deepest levels over."""
    rows = DIME_ROWS if rows is None else int(rows)
    if not 1 <= rows <= DIME_ROWS_MAX:
        raise ValueError(f"rows a run must be 1 to {DIME_ROWS_MAX}")
    group = moments_group(rows, nd, components)
    return DimePlan(rows, group, max(1, -(-n // (rows * group))))


def _node(nd):
    """Floats of a partial: the count, the mean, the cross-products."""
    return 1 + nd + nd * nd


def moments_group(rows, nd, components):
    """Runs a K8a block takes: :data:`DIME_GROUP_MAX`, halved until the
    block's rows, its runs' partials and its assignment fit
    :data:`DIME_GROUP_SMEM` (1 for wide rows)."""
    g = DIME_GROUP_MAX
    while g > 1 and moments_smem(rows, g, nd, components,
                                 True) > DIME_GROUP_SMEM:
        g //= 2
    return g


def moments_smem(rows, group, nd, components, staged):
    """K8a's dynamic shared memory: the span's rows (``staged``), the runs'
    partials (``group > 1``) and the span's assignment, each run's rows a
    row and its assignment a word apart (``csrc/dime_moments.cu``)."""
    span = rows * group
    return 4 * (((span + group) * nd if staged else 0)
                + (group * components * _node(nd) if group > 1 else 0)
                + span + group)


def moments_staged(rows, group, nd, components):
    """Whether K8a copies a block's rows into shared memory first (where
    they fit :data:`DIME_SMEM_MAX`), else reads them from global memory."""
    return moments_smem(rows, group, nd, components, True) <= DIME_SMEM_MAX


def finish_smem(blocks, nd, components):
    """K8b's dynamic shared memory with the partials and the factor's
    scratch in it: the totals and a flag, ``blocks * K`` partials, ``L``
    and ``L^-1`` of one component."""
    return 4 * (components + 1 + blocks * components * _node(nd)
                + 2 * nd * nd)


def finish_shared(blocks, nd, components):
    """Whether K8b works in shared memory (where :func:`finish_smem` fits),
    else in the partials' and the table's global memory."""
    return finish_smem(blocks, nd, components) <= DIME_SMEM_MAX


def table_size(nd, components):
    """Floats of a rung's K8c table: means, factors, inverses (``K`` of
    each), log-weights, log-determinants and the weights' running sum."""
    return components * (nd + 2 * nd * nd + 3)


def unpack_table(table, components, nd):
    """``(means, L, L_inv, logw, logdet, cdf)`` views of a table."""
    K = components
    sizes = (K * nd, K * nd * nd, K * nd * nd, K, K, K)
    parts = table.split(sizes, dim=-1)
    return (parts[0].unflatten(-1, (K, nd)),
            parts[1].unflatten(-1, (K, nd, nd)),
            parts[2].unflatten(-1, (K, nd, nd)), *parts[3:])


def _num(v, like):
    """The number ``v`` as a 0-d tensor of ``like``'s type and device (a
    divisor: torch divides by a Python number as a product by its
    reciprocal on the card, which rounds twice)."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _serial_sum(t):
    """``sum_k t_k`` over the last axis, from +0.0 in index order."""
    acc = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
    for k in range(t.shape[-1]):
        acc = acc + t[..., k]
    return acc


# -- K8a ------------------------------------------------------------------


def _set_rows(x, skip):
    """The rows of the set: ``x`` without rows ``[lo, lo + count)``."""
    lo, count = skip
    if not count:
        return x
    return torch.cat((x[..., :lo, :], x[..., lo + count:, :]), dim=-2)


def _assign_means(xs, mean, w, K):
    """The carry's component means, or at the cold start (``sum w == 0``,
    summed in order) the set's strided rows ``(k max(1, n // K)) % n``."""
    n = xs.shape[-2]
    idx = (torch.arange(K, device=xs.device) * max(1, n // K)) % n
    seeds = xs[..., idx, :]
    cold = _serial_sum(w.to(xs.dtype)) == 0.0
    return torch.where(cold[..., None, None], seeds, mean.to(xs.dtype))


def _assign(xs, mu):
    """Each row's nearest mean (the first of equals): ``|x - mu_k|^2``
    summed in column order."""
    K = mu.shape[-2]
    a = best = None
    for k in range(K):
        diff = xs - mu[..., k:k + 1, :]
        d = _serial_sum(diff * diff)
        if k == 0:
            a = torch.zeros(d.shape, dtype=torch.int64, device=xs.device)
            best = d
        else:
            better = d < best
            a = torch.where(better, k, a)
            best = torch.where(better, d, best)
    return a


def _partials(xs, member, rows):
    """The blocks' ``(count, mean, centered cross-products)`` of the rows
    ``xs`` (``(..., n, nd)``) under ``member`` (``(..., n, K)`` bool), as
    ``(..., blocks, K, 1 + nd + nd^2)``."""
    n, nd = xs.shape[-2:]
    K = member.shape[-1]
    nb = max(1, -(-n // rows))
    pad = nb * rows - n
    if pad:
        xs = torch.cat((xs, xs.new_zeros(xs.shape[:-2] + (pad, nd))), -2)
        member = torch.cat((member, member.new_zeros(
            member.shape[:-2] + (pad, K))), -2)
    lead = xs.shape[:-2]
    X = xs.reshape(lead + (nb, rows, 1, nd))
    M = member.reshape(lead + (nb, rows, K, 1))
    run = min(rows, n)  # rows of the fullest block
    # Each block's and component's first member: the shift of its sum.
    first = M[..., 0].to(torch.int8).argmax(dim=-2)
    shift = torch.take_along_dim(X.expand(lead + (nb, rows, K, nd)),
                                 first[..., None, :, None], dim=-3)
    xm = torch.where(M, X - shift, 0.0)
    mf = M[..., 0].to(xs.dtype)
    cnt = torch.zeros(lead + (nb, K), dtype=xs.dtype, device=xs.device)
    s = torch.zeros(lead + (nb, K, nd), dtype=xs.dtype, device=xs.device)
    for r in range(run):
        cnt = cnt + mf[..., r, :]
        s = s + xm[..., r, :, :]
    mu = torch.where(cnt[..., None] > 0, shift[..., 0, :, :]
                     + s / cnt[..., None], 0.0)
    t = torch.where(M, X - mu[..., None, :, :], 0.0)
    m2 = torch.zeros(lead + (nb, K, nd, nd), dtype=xs.dtype,
                     device=xs.device)
    for r in range(run):
        tr = t[..., r, :, :]
        m2 = m2 + tr[..., :, None] * tr[..., None, :]
    return torch.cat((cnt[..., None], mu, m2.flatten(-2)), dim=-1)


def dime_moments_plain(x, skip, mean, w, components, rows=None):
    """Plain PyTorch K8a: the blocks' partials ``(..., blocks, K, 1 + nd +
    nd^2)`` of the rows of ``x`` (``(nw, nd)`` or ``(T, nw, nd)``) outside
    ``skip = (lo, count)``: each run's, merged by the tree's first levels
    in groups of the plan's; ``mean`` ``(..., K, nd)`` and ``w`` ``(...,
    K)`` (the carry's; read for ``K > 1`` only) give the assignment."""
    xs = _set_rows(x, skip)
    K = int(components)
    plan = dime_plan(xs.shape[-2], xs.shape[-1], K, rows)
    if K > 1:
        a = _assign(xs, _assign_means(xs, mean, w, K))
        member = a[..., None] == torch.arange(K, device=x.device)
    else:
        member = torch.ones(xs.shape[:-1] + (1,), dtype=torch.bool,
                            device=x.device)
    runs = _partials(xs, member, plan.rows)
    return _merge_levels(runs, plan.group)[..., ::plan.group, :, :]


def masked_moments_plain(x, assign_means):
    """Per-component ``(count, mean, centered cov)`` of all rows of ``x``
    (``(n, nd)``) under the nearest of ``assign_means`` (``(K, nd)``), by
    K8a's partials and K8b's tree."""
    member = _assign(x, assign_means.to(x.dtype))[..., None] == torch.arange(
        assign_means.shape[-2], device=x.device)
    n, mu, m2 = _tree(_partials(x, member, DIME_ROWS))
    return n, mu, m2 / torch.clamp(n, min=1.0)[..., None, None]


def dime_moments(x, skip, mean, w, components, rows=None):
    """K8a on the rows' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (arguments as :func:`dime_moments_plain`;
    ``rows`` forces the run a block reduces)."""
    dev = x.device
    if dev.type == "cpu":
        return dime_moments_plain(x, skip, mean, w, components, rows)
    if dev.type != "cuda":
        raise ValueError(f"no K8a kernel for device {dev}")
    lead, nw, nd = _shape(x)
    lo, count = (int(v) for v in skip)
    n = nw - count
    K = int(components)
    if not (0 <= lo and 0 <= count and lo + count <= nw and n >= 1
            and K >= 1):
        raise ValueError(f"bad K8a set: rows {nw}, skip {skip}, K {K}")
    ntemps = lead[0] if lead else 1
    plan = dime_plan(n, nd, K, rows)
    if K > 1:
        check_f32("mean", mean, dev, lead + (K, nd))
        check_f32("w", w, dev, lead + (K,))
    node = 1 + nd + nd * nd
    if ntemps * plan.blocks * K * node >= 2**31 or n * nd >= 2**31:
        raise ValueError("K8a partials too many for int32 indexing")
    part = torch.empty(lead + (plan.blocks, K, node), dtype=torch.float32,
                       device=dev)
    launch("dime_moments", dev, x.data_ptr(), part.data_ptr(),
           ptr(mean if K > 1 else None), ptr(w if K > 1 else None), nw, nd,
           lo, count, K, plan.rows, plan.group, plan.blocks, ntemps,
           MOMENT_THREADS, int(moments_staged(plan.rows, plan.group, nd, K)))
    count_launches(dime_moments)
    return part


dime_moments.launches = 0
dime_moments.device_launches = None


def _shape(x):
    """``(lead, nw, nd)`` of a checked ``(nw, nd)`` / ``(T, nw, nd)``
    float32 buffer."""
    if x.dim() not in (2, 3):
        raise ValueError("x must be (nwalkers, ndim) or (T, nwalkers, ndim)")
    lead = tuple(int(t) for t in x.shape[:-2])
    nw, nd = (int(t) for t in x.shape[-2:])
    if nd < 1 or (lead and not 1 <= lead[0] < 65536):
        raise ValueError(f"bad K8 shape {tuple(x.shape)}")
    if x.numel() >= 2**31:
        raise ValueError("ensemble too large for int32 indexing")
    check_f32("x", x, x.device)
    return lead, nw, nd


# -- K8b ------------------------------------------------------------------


def _merge(A, B, nd):
    """Chan's combine of partials ``A`` and ``B`` (``(..., 1 + nd + nd^2)``):
    ``A`` where ``B`` is empty, ``B`` where ``A`` is."""
    na, nb = A[..., 0], B[..., 0]
    ma, mb = A[..., 1:1 + nd], B[..., 1:1 + nd]
    Ma = A[..., 1 + nd:].unflatten(-1, (nd, nd))
    Mb = B[..., 1 + nd:].unflatten(-1, (nd, nd))
    n = na + nb
    d = mb - ma
    coef = (na * nb) / n
    mean = ma + d * (nb / n)[..., None]
    m2 = (Ma + Mb) + coef[..., None, None] * (d[..., :, None]
                                             * d[..., None, :])
    out = torch.cat((n[..., None], mean, m2.flatten(-2)), dim=-1)
    return torch.where((nb == 0)[..., None], A,
                       torch.where((na == 0)[..., None], B, out))


def _merge_levels(part, upto):
    """The pairwise tree's levels ``s = 1, 2, 4, ...`` below ``upto`` over
    the partials (``(..., count, K, node)``): node ``p`` takes node ``p +
    s`` for ``p = 0, 2s, ...`` (K8a's groups, K8b's tree)."""
    nb, _, node = part.shape[-3:]
    nd = int(round(math.sqrt(node - 0.75) - 0.5))
    nodes = part
    s = 1
    while s < min(upto, nb):
        nodes = nodes.clone()
        nodes[..., 0:nb - s:2 * s, :, :] = _merge(
            nodes[..., 0:nb - s:2 * s, :, :], nodes[..., s:nb:2 * s, :, :],
            nd)
        s *= 2
    return nodes


def _tree(part):
    """K8b's pairwise tree over the partials (``(..., blocks, K, node)``):
    ``(count, mean, cross-products)`` of every component."""
    nd = int(round(math.sqrt(part.shape[-1] - 0.75) - 0.5))
    top = _merge_levels(part, math.inf)[..., 0, :, :]
    return (top[..., 0], top[..., 1:1 + nd],
            top[..., 1 + nd:].unflatten(-1, (nd, nd)))


def pool_plain(mean_h, cov_h, w, n, mean_b, cov_b, rho):
    """Pool a history ``(mean_h, cov_h, w)`` (decayed by ``rho``) with a
    batch's centered ``(n, mean_b, cov_b)`` by the parallel combine
    (``emcee_tpu/moves/dime.py:133-146``, ``:233-251``; the count clamped
    at 1e-12, which changes nothing with points).  Returns ``(mean, cov,
    total)``."""
    wh = rho * w
    total = wh + n
    safe = torch.clamp(total, min=1e-12)
    d = mean_b - mean_h
    mean = mean_h + d * (n / safe)[..., None]
    cov = ((wh[..., None, None] * cov_h + n[..., None, None] * cov_b)
           / safe[..., None, None]) + ((wh * n) / (safe * safe))[
        ..., None, None] * (d[..., :, None] * d[..., None, :])
    return mean, cov, total


def t_shape_chol_plain(cov, df):
    """Lower Cholesky factor of ``cov * (df - 2) / df + eps I`` (``cov``
    for ``df=None``; ``eps = 1e-6 tr / nd + 1e-12``), column by column;
    every entry NaN where a pivot is not > 0."""
    nd = cov.shape[-1]
    scale = 1.0 if df is None else (df - 2.0) / df
    tr = _serial_sum(torch.diagonal(cov, dim1=-2, dim2=-1))
    eps = 1e-6 * (tr / _num(nd, tr)) + 1e-12
    eye = torch.eye(nd, dtype=cov.dtype, device=cov.device)
    return chol_columns_plain(cov * scale + eps[..., None, None] * eye)


def chol_columns_plain(S):
    """The lower Cholesky factor of ``S`` (of each matrix of a batch),
    column by column in K8b's order; every entry NaN where a pivot is not
    > 0 (``cholesky_ex`` with ``info != 0``)."""
    nd = S.shape[-1]
    L = torch.zeros_like(S)
    ok = torch.ones(S.shape[:-2], dtype=torch.bool, device=S.device)
    for j in range(nd):
        s = S[..., j, j]
        for k in range(j):
            s = s - L[..., j, k] * L[..., j, k]
        ok = ok & (s > 0)
        ljj = torch.sqrt(s)
        L[..., j, j] = ljj
        if j + 1 < nd:
            t = S[..., j + 1:, j]
            for k in range(j):
                t = t - L[..., j + 1:, k] * L[..., j, k:k + 1]
            L[..., j + 1:, j] = t / ljj[..., None]
    return torch.where(ok[..., None, None], L, torch.nan)


def _tri_inverse(L):
    """``L^-1`` of lower-triangular factors, row by row: ``X_ij = (I_ij -
    sum_{k < i} L_ik X_kj) / L_ii``."""
    nd = L.shape[-1]
    eye = torch.eye(nd, dtype=L.dtype, device=L.device)
    X = torch.zeros_like(L)
    for i in range(nd):
        t = torch.zeros_like(L[..., i, :])
        for k in range(i):
            t = t + L[..., i, k:k + 1] * X[..., k, :]
        X[..., i, :] = (eye[i] - t) / L[..., i, i:i + 1]
    return X


def _weights(total):
    """Log-weights with the floor of ``emcee_tpu/moves/dime.py:267-270``
    and their running sum of ``exp``."""
    wf = (total + 1e-6 * _serial_sum(total)[..., None]) + 1e-30
    logw = torch.log(wf) - torch.log(_serial_sum(wf))[..., None]
    e = torch.exp(logw)
    acc = torch.zeros_like(e[..., 0])
    cdf = []
    for k in range(e.shape[-1]):
        acc = acc + e[..., k]
        cdf.append(acc)
    return logw, torch.stack(cdf, dim=-1)


def _finish_mode(mode):
    """``mode``'s kernel code (:data:`FINISH_MODES`), or a ValueError."""
    if mode not in FINISH_MODES:
        raise ValueError(f"mode must be one of {sorted(FINISH_MODES)}, got "
                         f"{mode!r}")
    return FINISH_MODES[mode]


def dime_finish_plain(part, mean=None, cov=None, w=None, cfg=None,
                      mode="table"):
    """Plain PyTorch K8b: the tree over ``part`` (K8a's), pooled with the
    carry ``mean``, ``cov``, ``w`` (each with the rung axis where ``part``
    has one, and the component axis for ``K > 1``).  ``mode`` is one of
    :data:`FINISH_MODES`: ``"table"`` returns the ``(..., table_size(nd,
    K))`` table; ``"update"`` writes the pooled moments into the carry in
    place and returns None; ``"walk"`` (``K = 1``; ``mean``, ``cov``,
    ``w`` and ``cfg`` unread) returns the factor of ``M2 / (n - 1)``,
    ``(..., nd, nd)``, the walk move's."""
    code = _finish_mode(mode)
    n, mu, m2 = _tree(part)
    if code == FINISH_MODES["walk"]:
        return chol_columns_plain(m2[..., 0, :, :]
                                  / (n[..., 0] - 1.0)[..., None, None])
    lead = part.shape[:-3]
    K = int(cfg.components)
    nd = mu.shape[-1]
    dt = part.dtype
    mh = mean.reshape(lead + (K, nd)).to(dt)
    ch = cov.reshape(lead + (K, nd, nd)).to(dt)
    wk = w.reshape(lead + (K,)).to(dt)
    cov_b = m2 / torch.clamp(n, min=1.0)[..., None, None]
    pm, pc, total = pool_plain(mh, ch, wk, n, mu, cov_b, cfg.rho)
    if code == FINISH_MODES["update"]:
        mean.copy_(pm.reshape(mean.shape))
        cov.copy_(pc.reshape(cov.shape))
        w.copy_(total.reshape(w.shape))
        return None
    L = t_shape_chol_plain(pc, cfg.df)
    Li = _tri_inverse(L)
    logdet = _serial_sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)))
    logw, cdf = _weights(total)
    return torch.cat((pm.flatten(-2), L.flatten(-3), Li.flatten(-3), logw,
                      logdet, cdf), dim=-1)


def dime_finish(part, mean=None, cov=None, w=None, cfg=None, mode="table"):
    """K8b on the partials' device: the CUDA kernel for CUDA tensors (which
    uses ``part`` as its scratch: its values are gone after the call), the
    plain version for CPU tensors.  Arguments as
    :func:`dime_finish_plain`."""
    code = _finish_mode(mode)
    walk = code == FINISH_MODES["walk"]
    dev = part.device
    if dev.type == "cpu":
        return dime_finish_plain(part, mean, cov, w, cfg, mode)
    if dev.type != "cuda":
        raise ValueError(f"no K8b kernel for device {dev}")
    if part.dim() not in (3, 4):
        raise ValueError("part must be (blocks, K, node) or (T, blocks, K, "
                         "node)")
    lead = tuple(int(t) for t in part.shape[:-3])
    nb, K, node = (int(t) for t in part.shape[-3:])
    nd = int(round(math.sqrt(node - 0.75) - 0.5))
    if 1 + nd + nd * nd != node or K != (1 if walk else int(cfg.components)):
        raise ValueError(f"bad K8b partials {tuple(part.shape)}")
    check_f32("part", part, dev)
    ntemps = lead[0] if lead else 1
    if walk:
        L = torch.empty(lead + (nd, nd), dtype=torch.float32, device=dev)
        launch("dime_finish", dev, part.data_ptr(), nb, nd, 1, None, None,
               None, L.data_ptr(), 0.0, 0.0, code, ntemps,
               FINISH_THREADS, int(finish_shared(nb, nd, 1)))
        count_launches(dime_finish)
        return L
    kk = (K,) if K > 1 else ()
    check_f32("mean", mean, dev, lead + kk + (nd,))
    check_f32("cov", cov, dev, lead + kk + (nd, nd))
    check_f32("w", w, dev, lead + kk)
    table = None if code == FINISH_MODES["update"] else torch.empty(
        lead + (table_size(nd, K),), dtype=torch.float32, device=dev)
    scale = 1.0 if cfg.df is None else (cfg.df - 2.0) / cfg.df
    launch("dime_finish", dev, part.data_ptr(), nb, nd, K, mean.data_ptr(),
           cov.data_ptr(), w.data_ptr(), ptr(table), float(cfg.rho),
           float(scale), code, ntemps, FINISH_THREADS,
           int(finish_shared(nb, nd, K)))
    count_launches(dime_finish)
    return table


dime_finish.launches = 0
dime_finish.device_launches = None


# -- K8c ------------------------------------------------------------------


def chi_square(n, df, seed, offset, device, dtype=torch.float32, row0=0,
               exhausted=None, plain=False, candidates=MT_CANDIDATES):
    """``n`` chi-square draws of ``df`` degrees of freedom for rows
    ``row0 ..``, from counters ``(row, CHI2_BLOCK | k, offset)`` (under a
    :class:`~.philox.RungKeys` ``seed``, ``(T, n)``).

    An integer ``df`` sums ``df`` squared Box-Muller normals in order (no
    loop that can fail).  Any other ``df`` takes the first accepted of
    ``candidates`` Marsaglia-Tsang candidates for a Gamma(df / 2)
    (candidate k: a normal from words 0 and 2, its uniform from word 1); a
    walker whose candidates are all refused gets ``df`` and adds one to
    ``exhausted`` (a 0-d int64 tensor), if given.  ``plain`` draws by the
    torch rounds (K8c's plain version)."""
    if float(df).is_integer():
        z = normals(n, int(df), seed, offset, device, dtype, row0=row0,
                    block=CHI2_BLOCK, plain=plain)
        return _serial_sum(z * z)
    w0, w1, w2, _ = row_words(n, candidates, CHI2_BLOCK, seed, offset,
                              device, row0, plain=plain)
    x = box_muller(w0, w2, dtype)
    u = to_uniform(w1, dtype)
    d = df / 2.0 - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    t = 1.0 + c * x
    v = (t * t) * t
    ok = (v > 0) & (torch.log(u) < ((0.5 * x) * x + d) - d * v
                    + d * torch.log(torch.clamp(v, min=1e-30)))
    first = ok.to(torch.int8).argmax(dim=-1, keepdim=True)
    got = ok.any(dim=-1)
    value = (2.0 * d) * v.gather(-1, first)[..., 0]
    if exhausted is not None:
        exhausted.add_((~got).sum())
    return torch.where(got, value, torch.full_like(value, df))


def _quad(xc, Li):
    """``|L^-1 xc|^2`` of rows ``xc`` (``(..., n, nd)``) under ``Li``
    (``(..., nd, nd)``): ``y_j = sum_i xc_i Li_ji`` and ``sum_j y_j^2``,
    each in index order."""
    y = torch.zeros_like(xc)
    for i in range(xc.shape[-1]):
        y = y + xc[..., i:i + 1] * Li[..., None, :, i]
    return _serial_sum(y * y)


def logq_plain(x, means, Li, logw, logdet, df, nd):
    """The mixture's log-density of rows ``x`` (``(..., n, nd)``) up to the
    shared constant: a logsumexp over the components of ``(logw - logdet)
    - (df + nd) / 2 log1p(m / df)`` (``- m / 2`` for ``df=None``), its
    maximum set to 0 where infinite (as ``torch.logsumexp``)."""
    comps = []
    for k in range(means.shape[-2]):
        m = _quad(x - means[..., None, k, :], Li[..., k, :, :])
        base = (logw[..., k] - logdet[..., k])[..., None]
        if df is None:
            comps.append(base - 0.5 * m)
        else:
            comps.append(base - ((df + nd) / 2.0)
                         * torch.log1p(m / _num(df, m)))
    mx = comps[0]
    for c in comps[1:]:
        mx = torch.where((c > mx) | torch.isnan(c), c, mx)
    mx = torch.where(mx.abs() == torch.inf, 0.0, mx)
    acc = torch.zeros_like(mx)
    for c in comps:
        acc = acc + torch.exp(c - mx)
    return torch.log(acc) + mx


def _take(x, idx):
    """Rows ``idx`` (``(..., n)``) of ``x`` (``(..., nw, nd)``)."""
    return torch.take_along_dim(x, idx[..., None], dim=-2)


def _draws_plain(ng, nd, seed, offset, dev, dt, row0, cfg, cdf, nc, extra,
                 exhausted):
    """K8c's draws (``extra``'s where it has them): ``z``, ``zg``,
    ``use_t``, the DE rows ``i`` and ``j`` (``j`` already past ``i``), the
    component ``comp`` and ``chi2``."""
    K = cfg.components
    de = cfg.aimh_prob < 1.0
    d = dict(extra)
    if "z" not in d or (de and "zg" not in d):
        zz = normals(ng, nd + de, seed, offset, dev, dt, row0=row0,
                     plain=True)
        d.setdefault("z", zz[..., :nd])
        if de:
            d.setdefault("zg", zz[..., nd:nd + 1])
    out = {"z": d["z"].to(dt)}
    u = None
    need = (("use_t", "i", "j") if de else ()) + (("comp",) if K > 1 else ())
    if any(k not in d for k in need):
        u = row_uniforms(ng, 4, seed, offset, dev, dt, row0=row0,
                         block=DIME_BLOCK, plain=True)
    if de:
        out["zg"] = d["zg"].to(dt).reshape(out["z"].shape[:-1] + (1,))
        use_t = d.get("use_t")
        out["use_t"] = (u[..., 0] < cfg.aimh_prob if use_t is None
                        else use_t.to(torch.bool))
        i = d.get("i")
        i = (torch.clamp((u[..., 1] * nc).to(torch.int64), max=nc - 1)
             if i is None else i.to(torch.int64))
        j = d.get("j")
        j = (torch.clamp((u[..., 2] * (nc - 1)).to(torch.int64), max=nc - 2)
             if j is None else j.to(torch.int64))
        out["i"], out["j"] = i, torch.where(j >= i, j + 1, j)
    if K > 1:
        comp = d.get("comp")
        out["comp"] = ((u[..., 3:4] >= cdf[..., None, :K - 1]).sum(-1)
                       if comp is None else comp.to(torch.int64))
    chi2 = d.get("chi2")
    if cfg.df is not None:
        out["chi2"] = (chi_square(ng, cfg.df, seed, offset, dev, dt,
                                  row0=row0, exhausted=exhausted, plain=True,
                                  candidates=cfg.candidates)
                       if chi2 is None else chi2.to(dt))
    return out


def dime_propose_plain(x, split, nsplits, table, seed, offset, cfg,
                       extra=None, exhausted=None):
    """Plain PyTorch K8c: the proposal ``(q, factor)`` of group ``split``
    of ``x`` (``(nw, nd)`` or ``(T, nw, nd)``) from K8b's ``table``, drawn
    under ``seed`` (an int, or the rungs' :class:`~.philox.RungKeys`) at
    ``offset``.  ``extra`` injects draws (the parity mode; each with the
    rung axis where ``x`` has one): ``z`` ``(ng, nd)``, ``zg`` ``(ng,
    1)``, ``use_t`` (bool), the raw DE picks ``i`` and ``j``, ``comp`` and
    ``chi2``.  Non-integer ``df``'s exhaustions add to ``exhausted``."""
    nw, nd = x.shape[-2:]
    ng = nw // nsplits
    nc = nw - ng
    row0 = split * ng
    K = cfg.components
    dev, dt = x.device, x.dtype
    s = x[..., row0:row0 + ng, :]
    mu, L, Li, logw, logdet, cdf = (t.to(dt) for t in unpack_table(
        table, K, nd))
    d = _draws_plain(ng, nd, seed, offset, dev, dt, row0, cfg, cdf, nc,
                     extra or {}, exhausted)
    z = d["z"]
    ts = None
    if cfg.df is not None:
        ts = torch.sqrt(_num(cfg.df, d["chi2"]) / d["chi2"])[..., None]
    # acc_k = L_k z of every component, each j summed over i in order.
    acc = torch.zeros(z.shape[:-2] + (K,) + z.shape[-2:], dtype=dt,
                      device=dev)
    for i in range(nd):
        acc = acc + z[..., None, :, i:i + 1] * L[..., :, None, :, i]
    if K == 1:
        a, mean = acc[..., 0, :, :], mu[..., 0:1, :]
        q_t = mean + (a if ts is None else a * ts)
    else:
        comp = d["comp"]
        a = torch.take_along_dim(
            acc, comp[..., None, :, None], dim=-3)[..., 0, :, :]
        mean = _take(mu, comp)
        a = mean + a
        q_t = a if ts is None else mean + (a - mean) * ts
    if cfg.aimh_prob >= 1.0:
        use_t = torch.ones(q_t.shape[:-1], dtype=torch.bool, device=dev)
        q = q_t
    else:
        use_t = d["use_t"]
        gamma = cfg.gamma0 * (1.0 + cfg.sigma * d["zg"])
        ci = _take(x, torch.where(d["i"] >= row0, d["i"] + ng, d["i"]))
        cj = _take(x, torch.where(d["j"] >= row0, d["j"] + ng, d["j"]))
        q = torch.where(use_t[..., None], q_t, s + gamma * (cj - ci))
    if K == 1:
        m_s = _quad(s - mu[..., 0:1, :], Li[..., 0, :, :])
        m_q = _quad(q_t - mu[..., 0:1, :], Li[..., 0, :, :])
        if cfg.df is None:
            f = 0.5 * (m_q - m_s)
        else:
            dfn = _num(cfg.df, m_s)
            f = (-(cfg.df + nd) / 2.0) * (torch.log1p(m_s / dfn)
                                          - torch.log1p(m_q / dfn))
    else:
        f = (logq_plain(s, mu, Li, logw, logdet, cfg.df, nd)
             - logq_plain(q_t, mu, Li, logw, logdet, cfg.df, nd))
    return q, torch.where(use_t, f, torch.zeros_like(f))


class _ProposeArgs(ctypes.Structure):
    """The arguments of ``emcee_dime_propose`` (``DimeProposeArgs`` in
    ``csrc/dime_propose.cu``, field for field)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "table", "q", "factor", "z_in", "zg_in", "i_in", "j_in",
        "use_in", "chi2_in", "comp_in", "exhausted", "offset_dev", "keys")
    ] + [("offset_inc", ctypes.c_ulonglong), ("seed", ctypes.c_ulonglong)] + [
        (name, ctypes.c_int) for name in (
            "nw", "nd", "ng", "split", "K", "ntemps", "df_mode", "df_int",
            "de", "draw_u", "threads", "candidates")
    ] + [(name, ctypes.c_float) for name in (
        "df", "mt_d", "mt_c", "mt_2d", "fac_t", "fac_mix", "aimh", "gamma0",
        "sigma")]


#: injected draws: key -> (dtype the kernel reads, trailing shape)
_INJECTED = {"z": (torch.float32, "nd"), "zg": (torch.float32, 1),
             "i": (torch.int32, None), "j": (torch.int32, None),
             "use_t": (torch.uint8, None), "chi2": (torch.float32, None),
             "comp": (torch.int32, None)}


def dime_propose(x, split, nsplits, table, seed, offset, cfg, extra=None,
                 exhausted=None):
    """K8c on the rows' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Arguments as :func:`dime_propose_plain`
    (``exhausted``, where given, a 0-d int64 tensor on the device)."""
    dev = x.device
    if dev.type == "cpu":
        return dime_propose_plain(x, split, nsplits, table, seed, offset,
                                  cfg, extra, exhausted)
    if dev.type != "cuda":
        raise ValueError(f"no K8c kernel for device {dev}")
    lead, nw, nd = _shape(x)
    K = int(cfg.components)
    if nsplits < 2 or nw % nsplits or not 0 <= split < nsplits:
        raise ValueError(f"bad split {split} of {nsplits} for {nw} walkers")
    ng = nw // nsplits
    nc = nw - ng
    ntemps = lead[0] if lead else 1
    check_f32("table", table, dev, lead + (table_size(nd, K),))
    extra = dict(extra or {})
    de = cfg.aimh_prob < 1.0
    # The injected draws as the kernel reads them; the copies are held until
    # the launch (one freed before it would be handed to the next copy).
    ptrs, held = {}, []
    for key, (dtype, tail) in _INJECTED.items():
        t = extra.pop(key, None)
        if t is None:
            continue
        tail = (nd,) if tail == "nd" else (() if tail is None else (tail,))
        t = t.to(device=dev, dtype=dtype).reshape(lead + (ng,) + tail)
        held.append(t.contiguous())
        ptrs[key] = held[-1].data_ptr()
    if extra:
        raise ValueError(f"unknown injected draws {sorted(extra)}")
    injected = ("z" in ptrs and (not de or all(
        k in ptrs for k in ("zg", "use_t", "i", "j")))
        and (K == 1 or "comp" in ptrs)
        and (cfg.df is None or "chi2" in ptrs))
    ntemps, keys, seed64 = key_args(seed, dev, ntemps, injected=injected)
    _, off_ptr, off = rng_args(0, offset, dev)
    if exhausted is not None and (exhausted.device != dev or exhausted.dtype
                                  != torch.int64 or exhausted.dim() != 0):
        raise ValueError("exhausted must be a 0-d int64 tensor on "
                         f"{dev}")
    q = torch.empty(lead + (ng, nd), dtype=torch.float32, device=dev)
    factor = torch.empty(lead + (ng,), dtype=torch.float32, device=dev)
    df = cfg.df
    df_mode = 0 if df is None else (1 if float(df).is_integer() else 2)
    mt_d = 0.0 if df_mode != 2 else df / 2.0 - 1.0 / 3.0
    args = _ProposeArgs(
        x=x.data_ptr(), table=table.data_ptr(), q=q.data_ptr(),
        factor=factor.data_ptr(), z_in=ptrs.get("z"), zg_in=ptrs.get("zg"),
        i_in=ptrs.get("i"), j_in=ptrs.get("j"), use_in=ptrs.get("use_t"),
        chi2_in=ptrs.get("chi2"), comp_in=ptrs.get("comp"),
        exhausted=ptr(exhausted), offset_dev=off_ptr, keys=keys,
        offset_inc=off, seed=seed64, nw=nw, nd=nd, ng=ng, split=split, K=K,
        ntemps=ntemps, df_mode=df_mode,
        df_int=int(df) if df_mode == 1 else 0, de=int(de),
        draw_u=int((de and any(k not in ptrs for k in ("use_t", "i", "j")))
                   or (K > 1 and "comp" not in ptrs)),
        threads=PROPOSE_THREADS, candidates=int(cfg.candidates),
        df=0.0 if df is None else float(df), mt_d=mt_d,
        mt_c=0.0 if df_mode != 2 else 1.0 / math.sqrt(9.0 * mt_d),
        mt_2d=2.0 * mt_d,
        fac_t=0.0 if df is None else -(df + nd) / 2.0,
        fac_mix=0.0 if df is None else (df + nd) / 2.0,
        aimh=float(cfg.aimh_prob), gamma0=float(cfg.gamma0),
        sigma=float(cfg.sigma))
    if ng:
        launch("dime_propose", dev, ctypes.addressof(args))
        count_launches(dime_propose)
    del held  # launched: a later allocation on this stream follows it
    return q, factor


dime_propose.launches = 0
dime_propose.device_launches = None
