"""K10: DE-Z's complement spread, proposal and archive fold, as CUDA
kernels and as plain PyTorch.

Held against ``emcee_tpu/moves/de_z.py``: the complement's per-column
spread and its floor (``get_proposal``, ``:185-189``), the picks from the
pool of the complement and the filled archive, the DE step with its gamma
jitter and ``g1_prob`` jump, the additive noise and the snooker update
with its Hastings factor (``:144-225``), and the archive ring's update
(``update_carry``, ``:227-280``).  The JAX package leaves that chain to
XLA; the port had it as plain torch (five pool gathers, a copy of the
complement, ~15 elementwise kernels and two K14 draws a split, five
launches a carry update).  Three kernels take its place:

* **K10a** :func:`dez_spread` (``csrc/dez_propose.cu``): a split
  reduction over the rows of a set, a split's complement read in place as
  two row ranges (``skip``: the split's own rows).  The set is cut into
  runs of :data:`DEZ_ROWS` rows; each run's count, its mean as an offset
  from the set's first row (the members' offsets from that row, summed in
  row order, over the count) and its centered sum of squares (in row
  order), column by column.  The summands and the means stay of the
  spread's size, so Chan's combine subtracts no two means near a large
  value (at mean 1e4 a mean rounded there is off by ~5e-4, and the merged
  spread by ~2e-5 relative).  A block takes ``group`` runs and merges them
  by the pairwise tree's first levels (level ``s``: node ``p`` takes node
  ``p + s`` for ``p = 0, 2s, ...``, Chan's combine); it writes one partial
  ``(count, mean[nd], M2[nd])``.  No atomics: every run gives the same
  bits.
* **K10b** :func:`dez_propose`: one thread a walker.  Its block's
  prologue merges K10a's partials by the rest of the tree (level by level
  in shared memory where they fit, :func:`tree_shared`; else a thread a
  column in a stack that gives the same bits), forms the
  spread ``sqrt(M2 / n)`` and its floor ``max(spread, 0.01 mean(spread) +
  1e-12)`` (the mean summed in column order) and the noise scale
  ``de_noise * spread`` (:func:`spread_plain` replays it).  Then each
  thread reads ``n_avail = nc + filled`` from the carry's device word,
  draws at the counters the plain torch move drew at (eight uniforms at
  ``(row, DEZ_BLOCK | k)``, ``1 + ndim`` normals at ``(row, NORMAL_BLOCK
  | k)``), picks ``min(int(u n), n - 1)`` in float32, reads the pool rows
  in place (a complement row through ``complement_rows``' mapping, or
  archive row ``r - nc``), and writes ``q`` and the factor: the DE step
  ``s + gamma (p_j - p_i)`` (``gamma = g0 (1 + sigma z_0)``, or 1 on a
  jump) plus the noise, or the snooker step with its factor (sums in
  column order from +0.0, the clamps at 1e-24).
* **K10c** :func:`dez_fold`: the archive update in one launch, one block
  a rung.  Rows ``(t + a stride) % nw`` of the post-accept ensemble go to
  slots ``(ptr + a) % capacity``; every thread reads the words before a
  block-wide barrier, and one thread advances ``filled``, ``ptr`` and
  ``t`` after it.

Every sum runs from +0.0 in a fixed order and every operation rounds once,
so on the card each kernel equals its plain version bit for bit (the plain
versions divide only by tensors: torch turns a division by a Python number
into a product by its reciprocal on the card).  On the CPU the plain
versions are the move's route, held to the JAX package within float32
rounding (the spread sums in K10a's order, not ``jnp.std``'s), and K10c's
to JAX's ``update_carry`` bit for bit.

On the rung axis (parallel tempering: ``emcee_tpu/parallel/tempering.py:
449-541`` vmaps DE-Z over the ladder with one archive a rung) ``x`` is
``(T, nw, nd)``, the archive ``(T, capacity, nd)``, the words ``(T,)``
and ``seed`` the rungs' :class:`~.philox.RungKeys`: every rung in one
launch of each kernel, each rung computed as alone.

What bounds them on an H100: the bytes (the complement once for K10a,
about 1 MB of a split's at 1e5 x 5; for K10b each walker's row, its five
pool rows gathered at random and its outputs; for K10c a few rows); the
Philox rounds of K10b's draws come close.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; it never falls back, and counts its launches in
``<wrapper>.launches`` (and ``<wrapper>.device_launches`` when set:
``_wrap.count_launches``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._wrap import check_f32, check_i32, complement_rows, count_launches
from ._wrap import key_args, launch, ptr, rng_args
from .philox import DEZ_BLOCK, normals, row_uniforms

__all__ = ["DEZ_ROWS", "DezConfig", "DezPlan", "dez_fold", "dez_fold_plain",
           "dez_plan", "dez_propose", "dez_propose_plain", "dez_spread",
           "dez_spread_plain", "propose_smem", "spread_plain", "spread_smem",
           "tree_shared"]

#: rows a run of K10a (the leaves of the partials' tree: the one plan
#: parameter that sets the bits).  On the H100, at DEZMove()'s shape at
#: 1e5 walkers, runs of 64 in blocks of 8 gave the least K10a + K10b time
#: of runs of 32-128 in blocks of 1-8: K10b's prologue grows with the
#: partials, K10a's serial chains with the rows a block (chip_smoke.py
#: k10_plan_sweep, PERF.md)
DEZ_ROWS = 64
#: the most runs a K10a block merges (kGroupMax in csrc/dez_propose.cu)
DEZ_GROUP_MAX = 8
#: the shared memory a K10a block may stage its rows in; wider spans are
#: read from global memory (with the runs' partials, a block stays under
#: the 48 KB that need no opt-in)
DEZ_SMEM = 40 * 1024
#: threads of a K10a block, of a K10b block, of K10c's one block a rung
SPREAD_THREADS = 256
PROPOSE_THREADS = 128
FOLD_THREADS = 256
#: the draws of a proposal, each injectable: the raw picks (``j`` before it
#: is moved past ``i``), the jump and snooker selects, the normals
DRAWS = ("i", "j", "a", "b", "e", "jump", "snooker", "z")


class DezPlan(NamedTuple):
    """How K10a cuts a set of rows."""

    rows: int  #: rows a run (sets the leaves of the tree)
    group: int  #: runs a K10a block, merged there (a power of two)
    #: K10a blocks a rung, ``ceil(n / (rows group))``: the partials
    blocks: int
    staged: int  #: 1: a block copies its rows to shared memory first


class DezConfig(NamedTuple):
    """A ``DEZMove``'s constants as K10b takes them."""

    gamma0: float  #: the DE stretch as float32 (``de_kernel.de_gamma0``)
    sigma: float
    g1_prob: float
    snooker_prob: float
    gammas: float
    de_noise: float
    ndim_m1: float  #: the snooker factor's exponent, global ndim - 1


def _staged_bytes(rows, group, nd):
    """K10a's shared memory for its staged rows: each run's rows and a
    word of padding (so that a block's runs start on other banks)."""
    return 4 * group * (rows * nd + 1)


def spread_smem(plan, nd):
    """K10a's dynamic shared memory: the staged rows (``plan.staged``) and
    the block's runs' partials (``csrc/dez_propose.cu``)."""
    rows = _staged_bytes(plan.rows, plan.group, nd) if plan.staged else 0
    return rows + 4 * plan.group * (1 + 2 * nd)


def dez_plan(n, nd, rows=None, group=None):
    """K10a's plan for a set of ``n`` rows of ``nd`` floats.  A run is
    :data:`DEZ_ROWS` (or ``rows``) rows whatever the card and the ladder,
    so a rung's bits never depend on either.  A block merges ``group``
    runs, which leaves the bits as they are: by default
    :data:`DEZ_GROUP_MAX`, halved until its rows fit :data:`DEZ_SMEM` to
    be staged in shared memory; where one run's rows do not fit, the
    block reads them from global memory and takes the full group."""
    rows = DEZ_ROWS if rows is None else int(rows)
    if not 1 <= rows <= 4096:
        raise ValueError("rows a run must be 1 to 4096")
    if group is None:
        group = DEZ_GROUP_MAX
        while group > 1 and _staged_bytes(rows, group, nd) > DEZ_SMEM:
            group //= 2
        if _staged_bytes(rows, group, nd) > DEZ_SMEM:
            group = DEZ_GROUP_MAX
    group = int(group)
    if group not in (1, 2, 4, 8):
        raise ValueError("runs a block must be 1, 2, 4 or 8")
    staged = _staged_bytes(rows, group, nd) <= DEZ_SMEM
    return DezPlan(rows, group, max(1, -(-n // (rows * group))), int(staged))


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


# -- K10a -----------------------------------------------------------------


def _set_rows(x, skip):
    """The rows of the set: ``x`` without rows ``[lo, lo + count)``."""
    lo, count = skip
    if not count:
        return x
    return torch.cat((x[..., :lo, :], x[..., lo + count:, :]), dim=-2)


def _runs(xs, rows):
    """Each run's ``(count, mean, M2)`` of the rows ``xs`` (``(..., n,
    nd)``), as ``(..., runs, 1 + 2 nd)``; the means are offsets from the
    set's first row."""
    n, nd = xs.shape[-2:]
    nr = -(-n // rows)
    pad = nr * rows - n
    lead = xs.shape[:-2]
    member = torch.ones(lead + (n,), dtype=torch.bool, device=xs.device)
    if pad:
        xs = torch.cat((xs, xs.new_zeros(lead + (pad, nd))), -2)
        member = torch.cat((member, member.new_zeros(lead + (pad,))), -1)
    X = xs.reshape(lead + (nr, rows, nd))
    M = member.reshape(lead + (nr, rows, 1))
    D = X - xs[..., None, 0:1, :]  # offsets from the set's first row
    cnt = torch.zeros(lead + (nr,), dtype=xs.dtype, device=xs.device)
    s = torch.zeros(lead + (nr, nd), dtype=xs.dtype, device=xs.device)
    xm = torch.where(M, D, 0.0)
    mf = M[..., 0].to(xs.dtype)
    for r in range(min(rows, n)):
        cnt = cnt + mf[..., r]
        s = s + xm[..., r, :]
    mu = s / cnt[..., None]
    t = torch.where(M, D - mu[..., None, :], 0.0)
    m2 = torch.zeros_like(s)
    for r in range(min(rows, n)):
        m2 = m2 + t[..., r, :] * t[..., r, :]
    return torch.cat((cnt[..., None], mu, m2), dim=-1)


def _merge(A, B):
    """Chan's combine of partials ``A`` and ``B`` (``(..., 1 + 2 nd)``),
    column by column: ``A`` where ``B`` is empty, ``B`` where ``A`` is."""
    nd = (A.shape[-1] - 1) // 2
    na, nb = A[..., 0], B[..., 0]
    ma, mb = A[..., 1:1 + nd], B[..., 1:1 + nd]
    qa, qb = A[..., 1 + nd:], B[..., 1 + nd:]
    n = na + nb
    d = mb - ma
    coef = (na * nb) / n
    mean = ma + d * (nb / n)[..., None]
    m2 = (qa + qb) + coef[..., None] * (d * d)
    out = torch.cat((n[..., None], mean, m2), dim=-1)
    return torch.where((nb == 0)[..., None], A,
                       torch.where((na == 0)[..., None], B, out))


def _merge_levels(part, upto):
    """The pairwise tree's levels ``s = 1, 2, 4, ...`` below ``upto`` over
    the partials (``(..., count, 1 + 2 nd)``): node ``p`` takes node ``p +
    s`` for ``p = 0, 2s, ...``."""
    nb = part.shape[-2]
    nodes = part
    s = 1
    while s < min(upto, nb):
        nodes = nodes.clone()
        nodes[..., 0:nb - s:2 * s, :] = _merge(
            nodes[..., 0:nb - s:2 * s, :], nodes[..., s:nb:2 * s, :])
        s *= 2
    return nodes


def dez_spread_plain(x, skip, rows=None, group=None):
    """Plain PyTorch K10a: the blocks' partials ``(..., blocks, 1 + 2 nd)``
    (``(count, mean, M2)`` of each column, the mean an offset from the
    set's first row) of the rows of ``x`` (``(nw,
    nd)`` or ``(T, nw, nd)``) outside ``skip = (lo, count)``: each run's,
    merged by the tree's first levels in groups of the plan's."""
    xs = _set_rows(x, skip)
    plan = dez_plan(xs.shape[-2], xs.shape[-1], rows, group)
    runs = _runs(xs, plan.rows)
    return _merge_levels(runs, plan.group)[..., ::plan.group, :]


def spread_plain(part):
    """K10b's prologue: the rest of the tree over K10a's partials, the
    complement's spread ``sqrt(M2 / n)`` of each column and its floor
    ``max(spread, 0.01 mean(spread) + 1e-12)``, the mean summed in column
    order: ``(..., nd)``."""
    nd = (part.shape[-1] - 1) // 2
    top = _merge_levels(part, float("inf"))[..., 0, :]
    spread = torch.sqrt(top[..., 1 + nd:] / top[..., :1])
    floor = 0.01 * (_serial_sum(spread) / _num(nd, spread)) + 1e-12
    return torch.maximum(spread, floor[..., None])


def _shape(x):
    """``(lead, nw, nd)`` of a checked ``(nw, nd)`` / ``(T, nw, nd)``
    float32 buffer."""
    if x.dim() not in (2, 3):
        raise ValueError("x must be (nwalkers, ndim) or (T, nwalkers, ndim)")
    lead = tuple(int(t) for t in x.shape[:-2])
    nw, nd = (int(t) for t in x.shape[-2:])
    if nd < 1 or nw < 1 or (lead and not 1 <= lead[0] < 65536):
        raise ValueError(f"bad K10 shape {tuple(x.shape)}")
    if x.numel() >= 2**31:
        raise ValueError("ensemble too large for int32 indexing")
    check_f32("x", x, x.device)
    return lead, nw, nd


def dez_spread(x, skip, rows=None, group=None):
    """K10a on the rows' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (arguments as
    :func:`dez_spread_plain`)."""
    dev = x.device
    if dev.type == "cpu":
        return dez_spread_plain(x, skip, rows, group)
    if dev.type != "cuda":
        raise ValueError(f"no K10a kernel for device {dev}")
    lead, nw, nd = _shape(x)
    lo, count = (int(v) for v in skip)
    n = nw - count
    if not (0 <= lo and 0 <= count and lo + count <= nw and n >= 1):
        raise ValueError(f"bad K10a set: rows {nw}, skip {skip}")
    ntemps = lead[0] if lead else 1
    plan = dez_plan(n, nd, rows, group)
    smem = spread_smem(plan, nd)
    if smem > 48 * 1024:
        raise ValueError(f"K10a: ndim {nd} too wide for a block's partials")
    part = torch.empty(lead + (plan.blocks, 1 + 2 * nd), dtype=torch.float32,
                       device=dev)
    launch("dez_spread", dev, x.data_ptr(), part.data_ptr(), nw, nd, lo,
           count, plan.rows, plan.group, plan.blocks, ntemps, SPREAD_THREADS,
           plan.staged, smem)
    count_launches(dez_spread)
    return part


dez_spread.launches = 0
dez_spread.device_launches = None


# -- K10b -----------------------------------------------------------------


def _pick(u, n):
    """``min(int(u * n), n - 1)`` (at least 0) for uniforms ``u`` and a
    row count ``n`` (an int64 tensor), in ``u``'s type: the port's
    ``randint(0, n)``."""
    n = n[..., None]
    k = torch.minimum((u * n.to(u.dtype)).to(torch.int64), n - 1)
    return torch.clamp(k, min=0)


def _draws_plain(ng, nd, seed, offset, dev, dt, row0, n_avail, cfg, extra):
    """K10b's draws (``extra``'s where it has them): the picks ``i``,
    ``j`` (past ``i``), ``a``, ``b``, ``e``, the bools ``jump`` and
    ``snooker`` and the normals ``z`` ``(..., ng, 1 + nd)``."""
    d = dict(extra)
    if any(k not in d for k in DRAWS[:-1]):
        u = row_uniforms(ng, 8, seed, offset, dev, dt, row0=row0,
                         block=DEZ_BLOCK, plain=True)
        for k, col in zip(("i", "a", "b", "e"), (0, 2, 3, 4)):
            d.setdefault(k, _pick(u[..., col], n_avail))
        d.setdefault("j", _pick(u[..., 1], n_avail - 1))
        d.setdefault("jump", u[..., 5] < cfg.g1_prob)
        d.setdefault("snooker", u[..., 6] < cfg.snooker_prob)
    if "z" not in d:
        d["z"] = normals(ng, 1 + nd, seed, offset, dev, dt, row0=row0,
                         plain=True)
    out = {k: d[k].to(torch.int64) for k in ("i", "j", "a", "b", "e")}
    out["j"] = torch.where(out["j"] >= out["i"], out["j"] + 1, out["j"])
    out["jump"] = d["jump"].to(torch.bool)
    out["snooker"] = d["snooker"].to(torch.bool)
    out["z"] = d["z"].to(dt)
    return out


def dez_propose_plain(x, split, nsplits, archive, filled, part, seed, offset,
                      cfg, extra=None):
    """Plain PyTorch K10b: the proposal ``(q, factor)`` of group ``split``
    of ``x`` (``(nw, nd)`` or ``(T, nw, nd)``) from the pool of its
    complement and the first ``filled`` rows of ``archive`` (``(capacity,
    nd)`` float32; ``filled`` an int32 word, each with the rung axis where
    ``x`` has one), the noise scaled by the spread of K10a's ``part``
    (None for ``de_noise == 0``), drawn under ``seed`` (an int, or the
    rungs' :class:`~.philox.RungKeys`) at ``offset``.  ``extra`` injects
    draws (the parity mode; each with the rung axis where ``x`` has one):
    the raw picks ``i, j, a, b, e`` (``j`` before it is moved past
    ``i``), the bools ``jump`` and ``snooker``, and ``z`` ``(ng, 1 +
    ndim)`` normals (the gamma jitter, then the noise)."""
    nw, nd = x.shape[-2:]
    ng = nw // nsplits
    nc = nw - ng
    row0 = split * ng
    dev, dt = x.device, x.dtype
    s = x[..., row0:row0 + ng, :]
    n_avail = nc + filled.to(torch.int64)
    d = _draws_plain(ng, nd, seed, offset, dev, dt, row0, n_avail, cfg,
                     extra or {})

    def pool(r):
        """Rows ``r`` of ``complement ++ archive[:filled]``."""
        crow = complement_rows(torch.clamp(r, max=nc - 1), split, ng)
        arow = torch.clamp(r - nc, min=0)
        return torch.where(
            (r < nc)[..., None], torch.take_along_dim(x, crow[..., None], -2),
            torch.take_along_dim(archive, arow[..., None], -2).to(dt))

    z = d["z"]
    gamma = cfg.gamma0 * (1.0 + cfg.sigma * z[..., :1])
    if cfg.g1_prob > 0.0:
        gamma = torch.where(d["jump"][..., None], torch.ones_like(gamma),
                            gamma)
    q = s + gamma * (pool(d["j"]) - pool(d["i"]))
    if cfg.de_noise > 0.0:
        scale = cfg.de_noise * spread_plain(part).to(dt)
        q = q + scale[..., None, :] * z[..., 1:]
    factors = torch.zeros(q.shape[:-1], dtype=dt, device=dev)
    if cfg.snooker_prob > 0.0:
        delta = s - pool(d["a"])
        norm = torch.sqrt(torch.clamp(_serial_sum(delta * delta),
                                      min=1e-24))
        u_dir = delta / norm[..., None]
        proj = _serial_sum(u_dir * (pool(d["b"]) - pool(d["e"])))
        gp = cfg.gammas * proj
        q_sn = s + u_dir * gp[..., None]
        f_sn = cfg.ndim_m1 * (torch.log(torch.clamp((norm + gp).abs(),
                                                    min=1e-24))
                              - torch.log(norm))
        use_sn = d["snooker"]
        q = torch.where(use_sn[..., None], q_sn, q)
        factors = torch.where(use_sn, f_sn, factors)
    return q, factors


class _ProposeArgs(ctypes.Structure):
    """The arguments of ``emcee_dez_propose`` (``DezProposeArgs`` in
    ``csrc/dez_propose.cu``, field for field)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "archive", "filled", "part", "q", "factor", "z_in", "i_in",
        "j_in", "a_in", "b_in", "e_in", "jump_in", "snooker_in",
        "offset_dev", "keys")
    ] + [("offset_inc", ctypes.c_ulonglong), ("seed", ctypes.c_ulonglong)] + [
        (name, ctypes.c_int) for name in (
            "nw", "nd", "ng", "split", "capacity", "ntemps", "blocks",
            "threads", "draw_u0", "draw_u1", "draw_z", "g1", "snooker",
            "tree_shared")
    ] + [(name, ctypes.c_float) for name in (
        "gamma0", "sigma", "g1_prob", "snooker_prob", "gammas", "de_noise",
        "ndim_m1")]


#: injected draws: key -> (dtype the kernel reads, trailing shape)
_INJECTED = {"i": (torch.int32, ()), "j": (torch.int32, ()),
             "a": (torch.int32, ()), "b": (torch.int32, ()),
             "e": (torch.int32, ()), "jump": (torch.uint8, ()),
             "snooker": (torch.uint8, ()), "z": (torch.float32, "z")}


def propose_smem(blocks, nd, shared):
    """K10b's dynamic shared memory where it forms the spread: the noise
    scale a column and the floor, and with ``shared`` K10a's ``blocks``
    partials (``csrc/dez_propose.cu``)."""
    return 4 * (nd + 1 + (blocks * (1 + 2 * nd) if shared else 0))


def tree_shared(blocks, nd):
    """Whether K10b's prologue merges the partials in shared memory (where
    they fit the 48 KB that need no opt-in), else a thread a column from
    global memory (the same bits)."""
    return propose_smem(blocks, nd, True) <= 48 * 1024


def _check_ring(archive, filled, dev, lead, nd):
    """The archive ``lead + (capacity, nd)`` float32 and its ``filled``
    word ``lead`` int32, on ``dev``."""
    if (archive.dim() != len(lead) + 2 or tuple(archive.shape[:-2]) != lead
            or archive.shape[-1] != nd or archive.shape[-2] < 1):
        raise ValueError(f"archive must be {lead + ('capacity', nd)}, got "
                         f"{tuple(archive.shape)}")
    check_f32("archive", archive, dev)
    check_i32("filled", filled, dev, lead)


def dez_propose(x, split, nsplits, archive, filled, part, seed, offset, cfg,
                extra=None):
    """K10b on the rows' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Arguments as
    :func:`dez_propose_plain`."""
    dev = x.device
    if dev.type == "cpu":
        return dez_propose_plain(x, split, nsplits, archive, filled, part,
                                 seed, offset, cfg, extra)
    if dev.type != "cuda":
        raise ValueError(f"no K10b kernel for device {dev}")
    lead, nw, nd = _shape(x)
    if nsplits < 2 or nw % nsplits or not 0 <= split < nsplits:
        raise ValueError(f"bad split {split} of {nsplits} for {nw} walkers")
    ng = nw // nsplits
    ntemps = lead[0] if lead else 1
    _check_ring(archive, filled, dev, lead, nd)
    noise = cfg.de_noise > 0.0
    blocks = shared = 0
    if noise:
        if part is None or part.dim() != len(lead) + 2:
            raise ValueError("de_noise > 0 takes K10a's partials")
        blocks = int(part.shape[-2])
        check_f32("part", part, dev, lead + (blocks, 1 + 2 * nd))
        shared = int(tree_shared(blocks, nd))
        if propose_smem(blocks, nd, shared) > 48 * 1024:
            raise ValueError(f"K10b: ndim {nd} too wide for a block's "
                             "spread")
    extra = dict(extra or {})
    ptrs, held = {}, []
    for key, (dtype, tail) in _INJECTED.items():
        t = extra.pop(key, None)
        if t is None:
            continue
        tail = (1 + nd,) if tail == "z" else tail
        t = t.to(device=dev, dtype=dtype).reshape(lead + (ng,) + tail)
        held.append(t.contiguous())
        ptrs[key] = held[-1].data_ptr()
    if extra:
        raise ValueError(f"unknown injected draws {sorted(extra)}")
    ntemps, keys, seed64 = key_args(seed, dev, ntemps,
                                    injected=all(k in ptrs for k in DRAWS))
    _, off_ptr, off = rng_args(0, offset, dev)
    q = torch.empty(lead + (ng, nd), dtype=torch.float32, device=dev)
    factor = torch.empty(lead + (ng,), dtype=torch.float32, device=dev)
    args = _ProposeArgs(
        x=x.data_ptr(), archive=archive.data_ptr(), filled=filled.data_ptr(),
        part=ptr(part) if noise else None, q=q.data_ptr(),
        factor=factor.data_ptr(), z_in=ptrs.get("z"), i_in=ptrs.get("i"),
        j_in=ptrs.get("j"), a_in=ptrs.get("a"), b_in=ptrs.get("b"),
        e_in=ptrs.get("e"), jump_in=ptrs.get("jump"),
        snooker_in=ptrs.get("snooker"), offset_dev=off_ptr, keys=keys,
        offset_inc=off, seed=seed64, nw=nw, nd=nd, ng=ng, split=split,
        capacity=int(archive.shape[-2]), ntemps=ntemps, blocks=blocks,
        threads=PROPOSE_THREADS,
        draw_u0=int(any(k not in ptrs for k in ("i", "j", "a", "b"))),
        draw_u1=int(any(k not in ptrs for k in ("e", "jump", "snooker"))),
        draw_z=int("z" not in ptrs), g1=int(cfg.g1_prob > 0.0),
        snooker=int(cfg.snooker_prob > 0.0), tree_shared=shared,
        gamma0=float(cfg.gamma0),
        sigma=float(cfg.sigma), g1_prob=float(cfg.g1_prob),
        snooker_prob=float(cfg.snooker_prob), gammas=float(cfg.gammas),
        de_noise=float(cfg.de_noise), ndim_m1=float(cfg.ndim_m1))
    if ng:
        launch("dez_propose", dev, ctypes.addressof(args))
        count_launches(dez_propose)
    del held  # launched: a later allocation on this stream follows it
    return q, factor


dez_propose.launches = 0
dez_propose.device_launches = None


# -- K10c -----------------------------------------------------------------


def _stride(nw, nrows):
    return max(1, nw // nrows)


def dez_fold_plain(x, archive, filled, ptr_, t, nrows):
    """Plain PyTorch K10c: rows ``(t + arange(nrows) * stride) % nw`` of
    ``x`` (``(nw, nd)`` or ``(T, nw, nd)``; ``stride = max(1, nw //
    nrows)``) written into ``archive`` (``(capacity, nd)``, with the rung
    axis where ``x`` has one) at slots ``(ptr + arange(nrows)) %
    capacity``, and the int32 words ``filled``, ``ptr_`` and ``t``
    advanced, all in place (``emcee_tpu/moves/de_z.py:227-280``)."""
    nw = x.shape[-2]
    k = archive.shape[-2]
    ar = torch.arange(nrows, dtype=torch.int64, device=x.device)
    idx = (t.to(torch.int64)[..., None] + ar * _stride(nw, nrows)) % nw
    slots = (ptr_.to(torch.int64)[..., None] + ar) % k
    if x.dim() == 3:
        base = torch.arange(x.shape[0], dtype=torch.int64,
                            device=x.device)[:, None]
        idx, slots = idx + base * nw, slots + base * k
    rows = x.reshape(-1, x.shape[-1]).index_select(0, idx.reshape(-1))
    archive.view(-1, archive.shape[-1]).index_copy_(
        0, slots.reshape(-1), rows.to(archive.dtype))
    filled.copy_(torch.clamp(filled + nrows, max=k))
    ptr_.copy_((ptr_ + nrows) % k)
    t.add_(1)


def dez_fold(x, archive, filled, ptr_, t, nrows):
    """K10c on the rows' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (arguments as :func:`dez_fold_plain`)."""
    dev = x.device
    if dev.type == "cpu":
        return dez_fold_plain(x, archive, filled, ptr_, t, nrows)
    if dev.type != "cuda":
        raise ValueError(f"no K10c kernel for device {dev}")
    lead, nw, nd = _shape(x)
    _check_ring(archive, filled, dev, lead, nd)
    check_i32("ptr", ptr_, dev, lead)
    check_i32("t", t, dev, lead)
    k = int(archive.shape[-2])
    nrows = int(nrows)
    if not 1 <= nrows <= min(k, nw):
        raise ValueError(f"rows a fold must be 1 to min(capacity {k}, "
                         f"walkers {nw}), got {nrows}")
    launch("dez_fold", dev, x.data_ptr(), archive.data_ptr(),
           filled.data_ptr(), ptr_.data_ptr(), t.data_ptr(), nw, nd, k,
           nrows, _stride(nw, nrows), lead[0] if lead else 1, FOLD_THREADS)
    count_launches(dez_fold)


dez_fold.launches = 0
dez_fold.device_launches = None
