"""K9: the slice move's stepping-out and shrinkage, as CUDA kernels and
as plain PyTorch, on loops whose every trip evaluates only the ends and
walkers still looping.

Held against ``emcee_tpu/moves/slice.py`` ``EnsembleSliceMove._inner``:
the pair, window and budget draws, the direction and the slice level
(``:158-202``), stepping out (``:204-241``), shrinkage (``:243-293``) and
the update (``:295-299``).  The JAX package runs both loops as
``while_loop``s in which every walker of the group evaluates in every
trip until the group's slowest lands; the port ran them so too, as ~20
masked torch launches a trip.  A walker's path through either loop
depends only on its own values and its own trip number, which equals the
group's trip counter for as long as it loops: an end expands in
consecutive trips from 0 until it fails, a walker shrinks in consecutive
trips from 0 until it lands.  So a trip that evaluates only the listed
ends or walkers (in walker order, their points in the first rows of one
evaluation buffer) leaves every walker as the masked trip does, the same
draws included.  Four kernels (``csrc/slice_loops.cu``):

* **K9a** :func:`slice_setup`: a thread a walker.  Draws the four
  uniforms at ``(row, SLICE_BLOCK)`` and the level's uniform at K2's
  accept counter (word 1 at ``(walker, split)``), or takes them injected;
  picks ``i, j`` of the complement (read in place, ``complement_rows``'
  mapping), forms ``eta = mu (c_i - c_j)`` (``mu`` times the tuned scale
  where there is one), ``y = lp + log u``, ``L = -u_2``, ``R = L + 1``,
  ``j_L`` and ``j_R``, and lists the ends that need an evaluation
  (``cnt < j``), codes ``2 i + side``, with their points.
* **K9b** :func:`slice_step_out`: a thread an entry.  An end inside the
  slice moves out by one, counts an expansion (an integer) and stays
  listed while ``cnt < j``; JAX's iteration counter follows its condition
  (``it < max_steps`` and an end still expanding).
* **K9c** :func:`slice_shrink`: a thread a walker still looping.  A
  walker inside the slice lands (``t``, its log-prob and its blob rows
  into ``t_acc``, ``lp_acc`` and ``blobs_acc``); otherwise it counts a
  contraction, moves ``L`` or ``R`` to ``t`` and, while the trip is below
  ``max_shrink``, stays listed with ``t = L + u (R - L)``, ``u`` word 0 at
  ``(row, SHRINK_BLOCK | trip)``.  ``setup=True`` (bucket 0) is the
  first list: every walker of the group.
* **K9d** :func:`slice_finish`: a thread a walker.  ``q = s + t_acc eta``,
  the log-prob and the blob rows where it landed; the acceptance and its
  count; the group's counts into the proposal's sums and the counters.

The list is compacted in a stable order: the plain versions by a stable
argsort (:func:`compact_plain`, the order of ``torch.nonzero``), the
kernels by a block scan and a decoupled look-back over the tiles before
(no atomics on the order).  Two lists and two evaluation buffers
alternate by the trip's parity.  A trip evaluates the first ``bucket``
rows of the buffer, the smallest bucket of ``chunk_graph.buckets`` that
holds the list's length when the block of trips begins
(``chunk_graph.bucket_of``);
rows past the length hold older points, finite, whose log-probs are never
read.

Every product and sum rounds once and ``log`` is libdevice's in both
versions, so on the card each kernel equals its plain version bit for
bit, every buffer the loop keeps included (the plain versions write the
rows the kernels write and no others).  On the CPU the plain versions are
the move's route, held to JAX's ``_inner`` under JAX's own draws within
float32 rounding.

On the rung axis (``emcee_tpu/parallel/tempering.py:449-541`` vmaps the
move over the ladder, one ``while_loop`` for every rung) every buffer has
a leading rung axis ``T``: each rung's list in its own rows ``[0, m_r)``
of a ``(T, bucket, ndim)`` batch, its own words and counters, its draws
under its own key at the one-ensemble counters, so every rung ends as that
rung alone.

What bounds them on an H100: latency; the bytes of a trip (a list entry,
its walker's words and log-prob, its next point) are tens of bytes an
entry, far below a launch at the list's tail.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; it never falls back, and counts its launches in
``<wrapper>.launches`` (and ``<wrapper>.device_launches`` when set:
``_wrap.count_launches``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ._wrap import check_f32, complement_rows, count_launches, key_args
from ._wrap import launch, ptr, rng_args
from .philox import (
    SHRINK_BLOCK, SLICE_BLOCK, RungKeys, philox4x32_torch, split_key,
    split_offset, to_uniform)

__all__ = ["LEAVES_MAX", "LoopState", "SliceConfig", "THREADS",
           "compact_plain", "slice_finish",
           "slice_finish_plain", "slice_setup", "slice_setup_plain",
           "slice_shrink", "slice_shrink_plain", "slice_step_out",
           "slice_step_out_plain"]

#: threads a block of every K9 kernel (kThreads in csrc/slice_loops.cu)
THREADS = 256
#: the blob leaves a launch takes (kMaxLeaves)
LEAVES_MAX = 16
#: a rung's words (kWords) and their slots
WORDS = 16
LEN, TRIP, DONE, SERIAL, NEXT, IT_OUT, IT_SHR, NEXP, NCON = range(9)
#: the draws of the setup, each injectable: the raw picks ``i``, ``j``
#: (``j`` before it is moved past ``i``), the window's uniform ``u``, the
#: left budget ``j_l`` and the level ``log_u``; and ``shrink_u`` ``(T,
#: ng, k)``, trip ``t``'s uniform in column ``t``
DRAWS = ("i", "j", "u", "j_l", "log_u")


class SliceConfig(NamedTuple):
    """An ``EnsembleSliceMove``'s constants as K9 takes them."""

    mu: float  #: the direction scale as float32
    max_steps: int
    max_shrink: int
    count_evals: bool  #: add each trip's length to the evaluation counter


def compact_plain(mask):
    """``(order, count)`` of each row of ``mask`` (``(T, K)`` bool): the
    indices of its True entries in index order (``torch.nonzero``'s), then
    the others; ``count`` the True entries, int32."""
    order = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)
    return order, mask.sum(-1, dtype=torch.int32)


class LoopState:
    """The loop state of K9 for ``T`` ensembles of groups of ``ng`` walkers
    of ``nd`` floats: each walker's direction, level, window ends, their
    budgets and expansions, and shrink point, the accepted point, log-prob and blob rows
    (``blobs``: the ensemble's blob leaves ``(T, nw, ...)``, their rows
    copied for a group of ``ng``), the two lists and evaluation buffers,
    the look-back's tile status, each rung's words, the proposal's sums
    ``(2, T)`` (expansions, contractions) and the counters ``(4, 2)``:
    JAX's loop iterations, trips run, evaluations needed (with
    ``count_evals``) and rows evaluated, stepping out and shrinkage, summed
    over groups and rungs."""

    def __init__(self, T, ng, nd, dtype, device, blobs=()):
        def f(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        def i(*shape, dt=torch.int32):
            return torch.zeros(shape, dtype=dt, device=device)

        cap = 2 * ng
        self.shape = (T, ng, nd)
        self.eta, self.y = f(T, ng, nd), f(T, ng)
        #: each walker's window ``[L, R]``, each end's budget and
        #: expansions: ``(T, ng, 2)``, so a list's code ``2 i + side``
        #: indexes a rung's ends as one axis of ``2 ng``
        self.ends = f(T, ng, 2)
        self.budget, self.cnt = i(T, ng, 2), i(T, ng, 2)
        self.t, self.t_acc, self.lp_acc = f(T, ng), f(T, ng), f(T, ng)
        self.done = i(T, ng, dt=torch.bool)
        self.blobs_acc = [torch.zeros((T, ng) + tuple(b.shape[2:]),
                                      dtype=b.dtype, device=device)
                          for b in blobs]
        self.lists = i(2, T, cap)
        self.pts = f(2, T, cap, nd)
        self.status = i(T, -(-cap // THREADS), dt=torch.int64)
        self.words = i(T, WORDS)
        self.sums = i(2, T)
        self.counters = i(4, 2, dt=torch.int64)

    @property
    def cap(self):
        return self.lists.shape[-1]

    def length(self):
        """Each rung's list length (a ``(T,)`` device view)."""
        return self.words[:, LEN]


# -- the plain versions ----------------------------------------------------


def _rounds(seed):
    """Philox round keys of ``seed``: a rung's ``(T, 1)`` pairs for a
    :class:`~.philox.RungKeys`, else the seed's."""
    if isinstance(seed, RungKeys):
        return tuple((a.view(-1, 1), b.view(-1, 1)) for a, b in seed.rounds)
    return None


def _words(seed, lanes, blocks, offset):
    """The four words at counters ``(lanes, blocks, offset)`` under
    ``seed`` (``lanes`` ``(n,)``, ``blocks`` an int or ``(T, 1)``): ``(T,
    n)`` tensors (a 1-row axis for an int seed)."""
    lo, hi = split_offset(offset)
    rounds = _rounds(seed)
    if rounds is None:
        words = philox4x32_torch(lanes, blocks, lo, hi, split_key(seed))
    else:
        words = philox4x32_torch(lanes, blocks, lo, hi, None, rounds=rounds)
    return tuple(w.reshape((-1, lanes.shape[0])) for w in words)


def _rows(t, idx):
    """``t[r, idx[r, k]]`` (``t`` ``(T, n, ...)``, ``idx`` ``(T, K)``
    int64)."""
    if t.dim() > 2:
        idx = idx.reshape(idx.shape + (1,) * (t.dim() - 2))
    return torch.take_along_dim(t, idx, dim=1)


def _group(x, split, nsplits):
    ng = x.shape[1] // nsplits
    return ng, split * ng


def _put(t, r, idx, v):
    """``t[r, idx] = v`` (1-D int64 index vectors)."""
    t.index_put_((r, idx), v.to(t.dtype))


def _point(x, st, split, codes, val):
    """The points ``s + val eta`` of walkers ``codes`` (``(T, K)``)."""
    ng = st.shape[1]
    s = _rows(x[:, split * ng:(split + 1) * ng], codes)
    return s + val[..., None] * _rows(st.eta, codes)


def _write_list(st, p, codes, vals_pts, m):
    """Entries ``[0, m_r)`` of list and evaluation buffer ``p`` of each
    rung: ``codes`` and the points ``vals_pts`` (``(T, K)`` / ``(T, K,
    nd)``), the rows past ``m_r`` kept."""
    K = codes.shape[1]
    lst, pts = st.lists[p][:, :K], st.pts[p][:, :K]
    ms = m if isinstance(m, list) else m.tolist()
    if min(ms) == max(ms):  # the same rows of every rung
        lst[:, :ms[0]] = codes[:, :ms[0]]
        pts[:, :ms[0]] = vals_pts[:, :ms[0]]
        return
    keep = (torch.arange(K, device=codes.device)
            < torch.tensor(ms, device=codes.device)[:, None])
    lst.copy_(torch.where(keep, codes, lst))
    pts.copy_(torch.where(keep[..., None], vals_pts, pts))


def slice_setup_plain(x, lp, split, nsplits, st, seed, offset, cfg,
                      scale=None, extra=None):
    """Plain PyTorch K9a for group ``split`` of ``x`` (``(T, nw, nd)``;
    ``lp`` its ``(T, nw)`` log-probs) into the loop state ``st``, drawn
    under ``seed`` (an int, or the rungs' :class:`~.philox.RungKeys`) at
    ``offset``; ``scale`` the tuned ``(T,)`` multiplier of ``mu`` or None;
    ``extra`` injects draws (:data:`DRAWS`, each ``(T, ng)``)."""
    T, nw, nd = x.shape
    ng, lo = _group(x, split, nsplits)
    nc = nw - ng
    dev, dt = x.device, x.dtype
    d = dict(extra or {})
    if any(k not in d for k in DRAWS[:4]):
        rows = torch.arange(lo, lo + ng, dtype=torch.int64, device=dev)
        u = [to_uniform(w, dt).expand(T, ng)
             for w in _words(seed, rows, SLICE_BLOCK, offset)]
        d.setdefault("i", torch.clamp((u[0] * nc).to(torch.int64),
                                      max=nc - 1))
        d.setdefault("j", torch.clamp((u[1] * (nc - 1)).to(torch.int64),
                                      max=nc - 2))
        d.setdefault("u", u[2])
        d.setdefault("j_l", torch.clamp(
            (u[3] * cfg.max_steps).to(torch.int32), max=cfg.max_steps - 1))
    if "log_u" not in d:
        lanes = torch.arange(ng, dtype=torch.int64, device=dev)
        d["log_u"] = torch.log(to_uniform(_words(seed, lanes, split,
                                                 offset)[1], dt)).expand(T, ng)
    i = d["i"].to(torch.int64).reshape(T, ng)
    j = d["j"].to(torch.int64).reshape(T, ng)
    j = torch.where(j >= i, j + 1, j)
    ci = _rows(x, complement_rows(i, split, ng))
    cj = _rows(x, complement_rows(j, split, ng))
    mu = float(np.float32(cfg.mu))
    if scale is not None:
        mu = (mu * scale.reshape(-1)).reshape(-1, 1, 1)
    st.eta.copy_(mu * (ci - cj))
    st.y.copy_(lp[:, lo:lo + ng] + d["log_u"].to(dt).reshape(T, ng))
    left = -d["u"].to(dt).reshape(T, ng)
    st.ends.copy_(torch.stack((left, left + 1.0), -1))
    jl = d["j_l"].to(torch.int32).reshape(T, ng)
    st.budget.copy_(torch.stack((jl, (cfg.max_steps - 1) - jl), -1))
    st.cnt.zero_()
    order, m = compact_plain(st.budget.view(T, 2 * ng) > 0)
    _write_list(st, 0, order, _point(x, st, split, order >> 1,
                                     _rows(st.ends.view(T, -1), order)), m)
    wd = st.words
    wd[:, LEN] = m
    wd[:, TRIP] = 0
    wd[:, IT_OUT] = int(cfg.max_steps > 0)
    wd[:, NEXP] = 0
    wd[:, NEXT] = m
    wd[:, SERIAL] += 1


def _trip_counts(st, loop, ms, bucket, cfg):
    """A trip's additions to the counters: one trip, ``T * bucket`` rows,
    and (with ``count_evals``) the lists' entries (``ms`` each rung's
    length)."""
    st.counters[1:, loop] += torch.tensor(  # trips, evaluations, rows
        (1, sum(ms) if cfg.count_evals else 0, len(ms) * bucket),
        dtype=st.counters.dtype, device=st.counters.device)


def _listed(st, parity, ms):
    """The first ``max(ms)`` entries of list ``parity`` (int64; those past
    a rung's length, ``ms`` on the host, set to 0: older lists' codes) and
    which are listed (None where every rung lists them all)."""
    cur = st.lists[parity][:, :max(ms)].long()
    if min(ms) == max(ms):
        return cur, None
    act = (torch.arange(cur.shape[1], device=cur.device)
           < torch.tensor(ms, device=cur.device)[:, None])
    return torch.where(act, cur, 0), act


def slice_step_out_plain(x, lp, split, nsplits, st, bucket, parity, cfg):
    """Plain PyTorch K9b: one stepping-out trip of the listed ends of list
    ``parity``, ``lp`` the ``(T, bucket)`` log-probs of their points."""
    T = x.shape[0]
    words = st.words.tolist()
    ms = [w[LEN] for w in words]
    _trip_counts(st, 0, ms, bucket, cfg)
    cur, act = _listed(st, parity, ms)
    if not cur.shape[1]:
        return
    ends, cnt = st.ends.view(T, -1), st.cnt.view(T, -1)
    inn = lp.reshape(T, bucket)[:, :cur.shape[1]] > _rows(st.y, cur >> 1)
    if act is not None:
        inn &= act
    c = _rows(cnt, cur) + 1
    surv = inn & (c < _rows(st.budget.view(T, -1), cur))
    # L - 1 or R + 1 (exact either way), for the ends inside the slice
    r_i, k_i = inn.nonzero(as_tuple=True)
    e = cur[r_i, k_i]
    _put(ends, r_i, e, ends[r_i, e] + ((e & 1) * 2 - 1))
    _put(cnt, r_i, e, c[r_i, k_i])
    order, m2 = compact_plain(surv)
    codes = torch.take_along_dim(cur, order, dim=1)
    m2 = m2.tolist()
    _write_list(st, parity ^ 1, codes, _point(x, st, split, codes >> 1,
                                              _rows(ends, codes)), m2)
    for w, n_in, n in zip(words, inn.sum(-1).tolist(), m2):
        if n_in:  # JAX's loop runs once more
            w[IT_OUT] = max(w[IT_OUT], min(w[TRIP] + 2, cfg.max_steps))
        w[NEXP] += n_in
    _advance(st, words, m2)


def _advance(st, words, m2):
    """A trip's words (``words`` each rung's, read on the host, ``m2`` the
    next lengths), written back: a rung that listed entries takes its next
    length and advances its trip and serial, as the kernels' last block
    does; the others keep theirs."""
    for w, n in zip(words, m2):
        if w[LEN]:
            w[LEN] = w[NEXT] = n
            w[TRIP] += 1
            w[SERIAL] += 1
    st.words.copy_(torch.tensor(words, dtype=st.words.dtype,
                                device=st.words.device))


def _shrink_uniforms(st, seed, offset, split, trip, shrink_u, dev, dt):
    """Each walker's shrink uniform at trip ``trip`` (``(T,)``): word 0 at
    ``(row, SHRINK_BLOCK | trip)``, or the injected column."""
    T, ng, _ = st.shape
    if shrink_u is not None:
        col = torch.clamp(trip, max=shrink_u.shape[-1] - 1).to(torch.int64)
        return torch.take_along_dim(
            shrink_u.to(dt).reshape(T, ng, -1),
            col.reshape(T, 1, 1).expand(T, ng, 1), dim=2)[..., 0]
    rows = torch.arange(split * ng, (split + 1) * ng, dtype=torch.int64,
                        device=dev)
    blocks = (SHRINK_BLOCK | trip.to(torch.int64)).reshape(-1, 1)
    return to_uniform(_words(seed, rows, blocks, offset)[0], dt).expand(T, ng)


def _next_t(x, st, split, codes, trip, seed, offset, shrink_u):
    """``t = L + u (R - L)`` of walkers ``codes`` at trip ``trip`` and
    their points."""
    u = _rows(_shrink_uniforms(st, seed, offset, split, trip, shrink_u,
                               x.device, x.dtype), codes)
    L, R = (_rows(st.ends[..., k], codes) for k in (0, 1))
    t = L + u * (R - L)
    return t, _point(x, st, split, codes, t)


def slice_shrink_plain(x, lp, blobs, split, nsplits, st, bucket, parity, seed,
                       offset, cfg, shrink_u=None):
    """Plain PyTorch K9c: one shrink trip of the listed walkers of list
    ``parity``, ``lp`` and ``blobs`` (leaves ``(T, bucket, ...)``) of their
    points; ``bucket`` 0 is the setup form (the first list, every walker).
    ``shrink_u`` injects the uniforms (``(T, ng, k)``, trip ``t`` in column
    ``t``)."""
    T, ng, _ = st.shape
    dev = x.device
    wd = st.words
    if not bucket:
        codes = torch.arange(ng, device=dev).expand(T, ng)
        zero = torch.zeros(T, dtype=torch.int32, device=dev)
        t, pts = _next_t(x, st, split, codes, zero, seed, offset, shrink_u)
        st.done.zero_()
        st.t.copy_(t)
        _write_list(st, 0, codes, pts, torch.full((T,), ng, device=dev))
        wd[:, LEN] = ng if cfg.max_shrink > 0 else 0
        wd[:, TRIP] = 0
        wd[:, IT_SHR] = 0
        wd[:, NCON] = 0
        return
    words = st.words.tolist()
    ms = [w[LEN] for w in words]
    _trip_counts(st, 1, ms, bucket, cfg)
    cur, act = _listed(st, parity, ms)
    K = cur.shape[1]
    if not K:
        return
    lpv = lp.reshape(T, bucket)[:, :K]
    tw = _rows(st.t, cur)
    ok = lpv > _rows(st.y, cur)
    miss = ~ok
    if act is not None:
        ok &= act
        miss &= act
    r_i, k_i = ok.nonzero(as_tuple=True)
    wk = cur[r_i, k_i]
    _put(st.t_acc, r_i, wk, tw[r_i, k_i])
    _put(st.lp_acc, r_i, wk, lpv[r_i, k_i])
    _put(st.done, r_i, wk, torch.ones_like(wk, dtype=torch.bool))
    for acc, b in zip(st.blobs_acc, blobs):
        acc.index_put_((r_i, wk), b.reshape((T, bucket) + acc.shape[2:])[
            r_i, k_i])
    r_i, k_i = miss.nonzero(as_tuple=True)
    t_m = tw[r_i, k_i]
    # L where t < 0, else R (NaN too)
    _put(st.ends.view(T, -1), r_i, 2 * cur[r_i, k_i] + (~(t_m < 0)).long(),
         t_m)
    trips = [w[TRIP] for w in words]
    # a walker that missed stays listed while its next trip is below the cap
    keeps = torch.tensor([t + 1 < cfg.max_shrink for t in trips],
                         device=dev)
    order, m2 = compact_plain(miss & keeps[:, None])
    codes = torch.take_along_dim(cur, order, dim=1)
    m2 = m2.tolist()
    t, pts = _next_t(x, st, split, codes,
                     torch.tensor(trips, device=dev) + 1, seed, offset,
                     shrink_u)
    keep = (torch.arange(K, device=dev)
            < torch.tensor(m2, device=dev)[:, None])
    r_i, k_i = keep.nonzero(as_tuple=True)
    _put(st.t, r_i, codes[r_i, k_i], t[r_i, k_i])
    _write_list(st, parity ^ 1, codes, pts, m2)
    for w, n_miss in zip(words, miss.sum(-1).tolist()):
        if w[LEN]:
            w[IT_SHR] = w[TRIP] + 1
        w[NCON] += n_miss
    _advance(st, words, m2)


def slice_finish_plain(x, lp, split, nsplits, st, accepted, count=None,
                       blobs=()):
    """Plain PyTorch K9d: the group's update of ``x`` and ``lp`` (and of
    the ensemble's blob leaves ``blobs``, ``(T, nw, ...)``) where its
    walkers landed, ``accepted`` (``(T, nw)`` bool) and ``count`` (int32 or
    None), and the group's counts into ``st.sums`` and the counters."""
    ng, lo = _group(x, split, nsplits)
    done = st.done
    s = x[:, lo:lo + ng]
    s.copy_(torch.where(done[..., None], s + st.t_acc[..., None] * st.eta, s))
    lp_s = lp[:, lo:lo + ng]
    lp_s.copy_(torch.where(done, st.lp_acc, lp_s))
    for acc, b in zip(st.blobs_acc, blobs):
        rows = b[:, lo:lo + ng]
        m = done.reshape(done.shape + (1,) * (rows.dim() - 2))
        rows.copy_(torch.where(m, acc, rows))
    accepted[:, lo:lo + ng] = done
    if count is not None:
        count[:, lo:lo + ng] += done
    wd = st.words
    st.sums[0] += wd[:, NEXP]
    st.sums[1] += wd[:, NCON]
    st.counters[0, 0] += wd[:, IT_OUT].sum()
    st.counters[0, 1] += wd[:, IT_SHR].sum()


# -- the wrappers -----------------------------------------------------------


class _Leaf(ctypes.Structure):
    """``SliceLeaf`` of ``csrc/slice_loops.cu``."""

    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("src_rung", ctypes.c_longlong),
                ("dst_rung", ctypes.c_longlong),
                ("row_bytes", ctypes.c_int), ("pad", ctypes.c_int)]


class _Args(ctypes.Structure):
    """``SliceArgs`` of ``csrc/slice_loops.cu``, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "lp_ens", "lp", "eta", "y", "ends", "budget", "cnt", "t",
        "t_acc", "lp_acc", "done", "lists", "pts", "status",
        "words", "counters", "sums", "scale", "accepted", "count", "i_in",
        "j_in", "u_in", "jl_in", "logu_in", "shrink_in", "offset_dev",
        "keys")
    ] + [("offset_inc", ctypes.c_ulonglong), ("seed", ctypes.c_ulonglong)] + [
        (name, ctypes.c_int) for name in (
            "nw", "nd", "ng", "split", "ntemps", "cap", "tiles", "bucket",
            "parity", "max_steps", "max_shrink", "count_evals",
            "shrink_cols", "nleaves")
    ] + [("mu", ctypes.c_float), ("leaves", _Leaf * LEAVES_MAX)]


#: K9d reads no constant of the move
_NO_CONFIG = SliceConfig(1.0, 1, 1, False)
#: injected draws: key -> the dtype the kernel reads
_INJECTED = {"i": torch.int32, "j": torch.int32, "u": torch.float32,
             "j_l": torch.int32, "log_u": torch.float32}


def _check(x, lp, st, split, nsplits):
    """The shapes the kernels take (``lp`` the ensemble's log-probs, or
    None); returns ``(T, nw, nd, ng)``."""
    if x.dim() != 3:
        raise ValueError("x must be (T, nwalkers, ndim)")
    T, nw, nd = (int(v) for v in x.shape)
    if nsplits < 2 or nw % nsplits or not 0 <= split < nsplits:
        raise ValueError(f"bad split {split} of {nsplits} for {nw} walkers")
    ng = nw // nsplits
    if nw - ng < 2 or not 1 <= T < 65536 or x.numel() >= 2**31:
        raise ValueError(f"bad K9 shape {tuple(x.shape)}")
    if st.shape != (T, ng, nd):
        raise ValueError(f"loop state {st.shape} for {(T, ng, nd)}")
    check_f32("x", x, x.device)
    if lp is not None:
        check_f32("lp", lp, x.device, (T, nw))
    for name in ("eta", "y", "ends", "t", "t_acc", "lp_acc", "pts"):
        check_f32(name, getattr(st, name), x.device)
    return T, nw, nd, ng


def _leaves(pairs, src_rows, dst_rows):
    """The descriptor table of leaf pairs ``(src, dst)``, rows ``src_rows``
    / ``dst_rows`` a rung, and its held contiguous sources."""
    if len(pairs) > LEAVES_MAX:
        raise ValueError(f"K9 takes at most {LEAVES_MAX} blob leaves")
    table = (_Leaf * LEAVES_MAX)()
    held = []
    for k, (src, dst) in enumerate(pairs):
        src = src.contiguous()
        if src.dtype != dst.dtype or not dst.is_contiguous():
            raise ValueError("blob leaves must match in dtype; buffers "
                             "contiguous")
        held.append(src)
        rb = dst.element_size() * int(np.prod(dst.shape[2:], dtype=np.int64))
        table[k] = _Leaf(src.data_ptr(), dst.data_ptr(), src_rows * rb,
                         dst_rows * rb, rb, 0)
    return table, held


def _args(x, lp_ens, st, split, seed, offset, cfg, T, nw, nd, ng, **kw):
    ntemps, keys, seed64 = key_args(seed, x.device, T,
                                    injected=kw.pop("injected", False))
    _, off_ptr, off = rng_args(0, offset, x.device)
    return _Args(
        x=x.data_ptr(), lp_ens=lp_ens.data_ptr(), eta=st.eta.data_ptr(),
        y=st.y.data_ptr(), ends=st.ends.data_ptr(),
        budget=st.budget.data_ptr(), cnt=st.cnt.data_ptr(),
        t=st.t.data_ptr(), t_acc=st.t_acc.data_ptr(),
        lp_acc=st.lp_acc.data_ptr(), done=st.done.data_ptr(),
        lists=st.lists.data_ptr(), pts=st.pts.data_ptr(),
        status=st.status.data_ptr(), words=st.words.data_ptr(),
        counters=st.counters.data_ptr(), sums=st.sums.data_ptr(),
        offset_dev=off_ptr, keys=keys, offset_inc=off, seed=seed64, nw=nw,
        nd=nd, ng=ng, split=split, ntemps=ntemps, cap=st.cap,
        tiles=st.status.shape[1], max_steps=cfg.max_steps,
        max_shrink=cfg.max_shrink, count_evals=int(cfg.count_evals),
        mu=float(np.float32(cfg.mu)), **kw)


def _cpu(x):
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no K9 kernel for device {x.device}")
    return False


def slice_setup(x, lp, split, nsplits, st, seed, offset, cfg, scale=None,
                extra=None):
    """K9a on the rows' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (arguments as :func:`slice_setup_plain`)."""
    if _cpu(x):
        return slice_setup_plain(x, lp, split, nsplits, st, seed, offset, cfg,
                                 scale, extra)
    T, nw, nd, ng = _check(x, lp, st, split, nsplits)
    extra = dict(extra or {})
    ptrs, held = {}, []
    for key, dtype in _INJECTED.items():
        v = extra.pop(key, None)
        if v is not None:
            held.append(v.to(device=x.device, dtype=dtype).reshape(
                T, ng).contiguous())
            ptrs[key] = held[-1].data_ptr()
    if extra:
        raise ValueError(f"unknown injected draws {sorted(extra)}")
    if scale is not None:
        held.append(scale.reshape(-1).to(torch.float32).contiguous())
        if held[-1].numel() != T:
            raise ValueError(f"scale must hold one value a rung ({T})")
    args = _args(x, lp, st, split, seed, offset, cfg, T, nw, nd, ng,
                 injected=len(ptrs) == len(_INJECTED),
                 scale=held[-1].data_ptr() if scale is not None else None,
                 i_in=ptrs.get("i"), j_in=ptrs.get("j"), u_in=ptrs.get("u"),
                 jl_in=ptrs.get("j_l"), logu_in=ptrs.get("log_u"))
    launch("slice_setup", x.device, ctypes.addressof(args))
    count_launches(slice_setup)
    del held  # launched: a later allocation on this stream follows it


slice_setup.launches = 0
slice_setup.device_launches = None


def slice_step_out(x, lp, split, nsplits, st, bucket, parity, cfg):
    """K9b on the rows' device (arguments as
    :func:`slice_step_out_plain`)."""
    if _cpu(x):
        return slice_step_out_plain(x, lp, split, nsplits, st, bucket, parity,
                                    cfg)
    T, nw, nd, ng = _check(x, None, st, split, nsplits)
    lp = lp.reshape(T, bucket)
    check_f32("lp", lp, x.device, (T, bucket))
    if not 1 <= bucket <= st.cap or parity not in (0, 1):
        raise ValueError(f"bad K9b bucket {bucket} or parity {parity}")
    args = _args(x, x, st, split, 0, 0, cfg, T, nw, nd, ng, injected=True,
                 lp=lp.data_ptr(), bucket=bucket, parity=parity)
    launch("slice_step_out", x.device, ctypes.addressof(args))
    count_launches(slice_step_out)


slice_step_out.launches = 0
slice_step_out.device_launches = None


def slice_shrink(x, lp, blobs, split, nsplits, st, bucket, parity, seed,
                 offset, cfg, shrink_u=None):
    """K9c on the rows' device (arguments as :func:`slice_shrink_plain`;
    ``blobs`` the leaves of the trip's blobs, ``(T, bucket, ...)``)."""
    if _cpu(x):
        return slice_shrink_plain(x, lp, blobs, split, nsplits, st, bucket,
                                  parity, seed, offset, cfg, shrink_u)
    T, nw, nd, ng = _check(x, None, st, split, nsplits)
    held = []
    kw = {}
    if bucket:
        lp = lp.reshape(T, bucket)
        check_f32("lp", lp, x.device, (T, bucket))
        if not 1 <= bucket <= st.cap or parity not in (0, 1):
            raise ValueError(f"bad K9c bucket {bucket} or parity {parity}")
        if len(blobs) != len(st.blobs_acc):
            raise ValueError("K9c: the trip's blob leaves and the loop "
                             "state's differ")
        table, held = _leaves(
            [(b.reshape((T, bucket) + a.shape[2:]), a)
             for b, a in zip(blobs, st.blobs_acc)], bucket, ng)
        kw = dict(lp=lp.data_ptr(), leaves=table, nleaves=len(blobs))
    if shrink_u is not None:
        cols = max(1, cfg.max_shrink)
        held.append(shrink_u.to(device=x.device, dtype=torch.float32)
                    .reshape(T, ng, -1).contiguous())
        if held[-1].shape[-1] < cols:
            raise ValueError(f"shrink_u must hold {cols} trips")
        kw.update(shrink_in=held[-1].data_ptr(),
                  shrink_cols=held[-1].shape[-1])
    args = _args(x, x, st, split, seed, offset, cfg, T, nw, nd, ng,
                 injected=shrink_u is not None, bucket=bucket, parity=parity,
                 **kw)
    launch("slice_shrink", x.device, ctypes.addressof(args))
    count_launches(slice_shrink)
    del held


slice_shrink.launches = 0
slice_shrink.device_launches = None


def slice_finish(x, lp, split, nsplits, st, accepted, count=None, blobs=()):
    """K9d on the rows' device (arguments as :func:`slice_finish_plain`)."""
    if _cpu(x):
        return slice_finish_plain(x, lp, split, nsplits, st, accepted, count,
                                  blobs)
    T, nw, nd, ng = _check(x, lp, st, split, nsplits)
    if (accepted.dtype != torch.bool or tuple(accepted.shape) != (T, nw)
            or not accepted.is_contiguous()):
        raise ValueError(f"accepted must be a contiguous ({T}, {nw}) bool "
                         "tensor")
    if count is not None and (count.dtype != torch.int32
                              or tuple(count.shape) != (T, nw)
                              or not count.is_contiguous()):
        raise ValueError(f"count must be a contiguous ({T}, {nw}) int32 "
                         "tensor")
    if len(blobs) != len(st.blobs_acc):
        raise ValueError("K9d: the ensemble's blob leaves and the loop "
                         "state's differ")
    table, held = _leaves(list(zip(st.blobs_acc, blobs)), ng, nw)
    args = _args(x, lp, st, split, 0, 0, _NO_CONFIG, T, nw, nd, ng,
                 injected=True, accepted=accepted.data_ptr(),
                 count=ptr(count), leaves=table, nleaves=len(blobs))
    launch("slice_finish", x.device, ctypes.addressof(args))
    count_launches(slice_finish)
    del held


slice_finish.launches = 0
slice_finish.device_launches = None
