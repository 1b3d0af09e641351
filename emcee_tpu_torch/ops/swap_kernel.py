"""K15: the even/odd swap of a tempered ladder, as a CUDA kernel and as
plain PyTorch.

Held against ``emcee_tpu/parallel/tempering.py:543-580``
(``PTSampler._swap_step``) with the parity and ``swap_every`` choice of
``:752-796``.  The kernel is ``csrc/pt_swap.cu``; it is bound by latency
(a few tens of KB a launch at the tempered workload's shape).

The ladder's buffers are ``coords`` ``(T, nwalkers, ndim)``, ``log_like``,
``log_prior`` and ``log_prob`` (the tempered ``beta logL + logP``) ``(T,
nwalkers)``, ``betas`` ``(T,)`` float32 and ``counts`` ``(T - 1,)`` int64;
a swap updates them in place.  The proposal's step is its Philox offset
(an int, or a :class:`~.philox.DeviceOffset` that the kernel reads on the
card, so one recorded graph serves every replay whatever its parity):
nothing happens unless ``step % swap_every == swap_every - 1``; the step's
parity ``p`` pairs rungs ``(lo, lo + 1)``, ``lo = p, p + 2, ... < T - 1``.
For each pair and walker the accept uniform is word 0 of counter
``(walker, SWAP_BLOCK | lo, step)`` under the chain's seed, or row ``k``
of the injected ``u`` ``(P, nwalkers)`` for the parity's ``k``-th pair
(the parity mode, against the JAX package's draws).  An accepted walker's
coords row, ``log_like`` and ``log_prior`` change rungs, its ``log_prob``
on each rung is formed anew from them (``-inf`` where ``log_prior`` is
not above ``-inf``), and ``counts[lo]`` counts it.

``leaves`` are the user blob leaves of the likelihood, each a contiguous
``(T, nwalkers, ...)`` buffer of any dtype and row shape: an accepted
walker's row of every leaf changes rungs with its coords row, as the JAX
package exchanges every leaf of ``(coords, logL, logP, blobs)`` together
(``:573-580``).  The kernel copies bytes (the largest unit of 16, 8, 4,
2 and 1 bytes that divides the leaf's base and row,
:func:`swap_leaves`), never converts them, so the plain version's
``torch.where`` and the kernel agree bit for bit.  Up to
``SWAP_REG_LEAVES`` leaves whose rows are one 4-byte unit (or, where
there is none, one 8-byte unit) go through registers, loaded before the
decision; the rest through a table in shared memory, after it.  One
launch takes up to ``SWAP_LEAVES`` table leaves; more raise.
:func:`swap_plan` sizes the block (the largest of 128, 64 and 32
threads whose grid still has a block for every SM: 32 at workload 4's
shape, so 64 SMs carry a block each) and orders the leaves.

:func:`pt_swap` launches the kernel for CUDA tensors and uses
:func:`pt_swap_plain` for CPU tensors; it never falls back from one to
the other.  ``pt_swap.launches`` counts kernel launches (and
``pt_swap.device_launches``, when set, on the card:
``_wrap.count_launches``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._wrap import (
    check_f32, count_launches, device_sm_count, launch, ptr, rng_args)
from .philox import (
    SWAP_BLOCK, RungKeys, philox4x32, split_key, split_offset, to_uniform)
from .philox import _cpu_offset as _step  # a device word is read: a sync

__all__ = ["SWAP_LEAVES", "SWAP_REG_LEAVES", "SWAP_ROW_REGS",
           "SWAP_THREADS_MAX", "SwapPlan", "pt_swap", "pt_swap_plain",
           "swap_leaves", "swap_pairs", "swap_plan", "tempered_log_prob"]

#: the largest block of the kernel (kMaxThreads in csrc/pt_swap.cu)
SWAP_THREADS_MAX = 128
#: user blob leaves one launch exchanges through its table (kMaxLeaves in
#: csrc/pt_swap.cu), beside its register leaves
SWAP_LEAVES = 16
#: scalar leaves one launch exchanges through registers (kRegLeaves)
SWAP_REG_LEAVES = 4
#: coordinates a row that the kernel loads before the decision (kRowRegs;
#: longer rows are exchanged after it)
SWAP_ROW_REGS = 8


class SwapPlan(NamedTuple):
    """How the kernel is launched: the C entry point's arguments."""

    threads: int  #: threads a block, a multiple of 32
    n_reg: int  #: the leading leaves that go through registers
    reg_unit: int  #: their row's bytes, 4 or 8 (0 without register leaves)


def swap_plan(nw, ntemps, n_sm, table=()):
    """The launch plan for ``ntemps`` rungs of ``nw`` walkers on a card of
    ``n_sm`` SMs with leaf descriptors ``table`` (:func:`swap_leaves`),
    and the descriptors in launch order: ``(SwapPlan, descriptors)``.

    The block is the largest of 128, 64 and 32 threads whose grid
    (``ceil(nw / threads) x ntemps // 2``) has a block for every SM, else
    32.  Up to ``SWAP_REG_LEAVES`` leaves whose rows are one 4-byte unit
    (where there is none, one 8-byte unit) go first, through registers;
    every other leaf follows in its own order, through the table."""
    threads = SWAP_THREADS_MAX
    while threads > 32 and -(-nw // threads) * (ntemps // 2) < n_sm:
        threads //= 2
    for unit in (4, 8):
        reg = [i for i, d in enumerate(table)
               if d[1] == d[2] == unit][:SWAP_REG_LEAVES]
        if reg:
            order = ([table[i] for i in reg]
                     + [d for i, d in enumerate(table) if i not in reg])
            return SwapPlan(threads, len(reg), unit), order
    return SwapPlan(threads, 0, 0), list(table)


class _SwapLeaf(ctypes.Structure):
    """One user blob leaf as the C entry point takes it (``SwapLeaf`` in
    ``csrc/pt_swap.cu``)."""

    _fields_ = [("base", ctypes.c_void_p), ("row_bytes", ctypes.c_int),
                ("unit", ctypes.c_int)]


def swap_leaves(leaves, ntemps, nw, device):
    """The kernel's descriptors ``(base pointer, row bytes, unit)`` of
    checked user blob leaves (each row of a byte or more; empty rows are
    left out): the unit is the largest of 16, 8, 4, 2 and 1 bytes that
    divides both the base address and the row, so no unit holds bytes of
    two walkers."""
    out = []
    for leaf in leaves:
        if (leaf.device != device or leaf.dim() < 2
                or tuple(leaf.shape[:2]) != (ntemps, nw)
                or not leaf.is_contiguous()):
            raise ValueError(
                f"a blob leaf must be a contiguous ({ntemps}, {nw}, ...) "
                f"tensor on {device}, got {tuple(leaf.shape)} on "
                f"{leaf.device}")
        row = leaf[0, 0].numel() * leaf.element_size()
        if not row:
            continue
        base = leaf.data_ptr()
        unit = next(u for u in (16, 8, 4, 2, 1)
                    if not (base % u or row % u))
        out.append((base, row, unit))
    if len(out) - swap_plan(nw, ntemps, 1, out)[0].n_reg > SWAP_LEAVES:
        raise ValueError(f"K15 exchanges at most {SWAP_LEAVES} blob leaves "
                         f"a launch through its table (and "
                         f"{SWAP_REG_LEAVES} scalars through registers), "
                         f"got {len(out)}")
    return out


def swap_pairs(step, ntemps, swap_every):
    """The lower rungs of the pairs a proposal at ``step`` swaps: ``range(
    step % 2, ntemps - 1, 2)``, or none when ``swap_every < 1`` or the
    step is not a swap step."""
    if swap_every < 1 or step % swap_every != swap_every - 1:
        return range(0)
    return range(step % 2, ntemps - 1, 2)


def tempered_log_prob(beta, log_like, log_prior):
    """``beta * logL + logP``, ``-inf`` where ``logP`` is not above
    ``-inf``: one multiply and one add, each rounded, in this order (the
    tempered model, K15 and the plain versions all form it so)."""
    return torch.where(log_prior > -torch.inf, beta * log_like + log_prior,
                       -torch.inf)


def _chain_seed(seed):
    return seed.seed if isinstance(seed, RungKeys) else int(seed)


def pt_swap_plain(coords, log_like, log_prior, log_prob, betas, counts, *,
                  seed=0, offset=0, swap_every=1, u=None, leaves=()):
    """Plain PyTorch K15: the swap of the proposal at ``offset``, in place.
    ``u`` ``(P, nwalkers)`` injects the uniforms of the step's ``P``
    pairs; ``leaves`` are the user blob leaves that move with the
    walkers."""
    ntemps, nw = log_like.shape
    step = _step(offset)
    pairs = swap_pairs(step, ntemps, swap_every)
    if not len(pairs):
        return
    dev = log_like.device
    lo = torch.tensor(list(pairs), dtype=torch.int64, device=dev)
    hi = lo + 1
    if u is None:
        lanes = torch.arange(nw, dtype=torch.int64, device=dev)
        o_lo, o_hi = split_offset(step)
        u = to_uniform(philox4x32(lanes[None, :], (SWAP_BLOCK | lo)[:, None],
                                  o_lo, o_hi,
                                  split_key(_chain_seed(seed)))[0])
    b_lo, b_hi = betas[lo], betas[hi]
    acc = torch.log(u) < (b_lo - b_hi)[:, None] * (log_like[hi]
                                                   - log_like[lo])
    for arr in (coords, log_like, log_prior, *leaves):
        m = acc.view(acc.shape + (1,) * (arr.dim() - 2))
        a_lo, a_hi = arr[lo], arr[hi]
        arr[lo] = torch.where(m, a_hi, a_lo)
        arr[hi] = torch.where(m, a_lo, a_hi)
    for rows, beta in ((lo, b_lo), (hi, b_hi)):
        log_prob[rows] = torch.where(
            acc, tempered_log_prob(beta[:, None], log_like[rows],
                                   log_prior[rows]), log_prob[rows])
    counts.index_add_(0, lo, acc.sum(dim=1))


def pt_swap(coords, log_like, log_prior, log_prob, betas, counts, *, seed=0,
            offset=0, swap_every=1, u=None, leaves=()):
    """K15 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Launches nothing where no proposal
    swaps (``swap_every < 1`` or fewer than two rungs)."""
    args = (coords, log_like, log_prior, log_prob, betas, counts)
    kw = dict(seed=seed, offset=offset, swap_every=swap_every, u=u,
              leaves=leaves)
    if coords.device.type == "cpu":
        return pt_swap_plain(*args, **kw)
    if coords.device.type != "cuda":
        raise ValueError(f"no K15 kernel for device {coords.device}")
    if coords.dim() != 3:
        raise ValueError("coords must be (ntemps, nwalkers, ndim)")
    ntemps, nw, nd = coords.shape
    if ntemps < 2 or swap_every < 1:
        return None
    if coords.numel() >= 2**31:
        raise ValueError("ladder too large for int32 indexing")
    dev = coords.device
    check_f32("coords", coords, dev)
    for name, t in (("log_like", log_like), ("log_prior", log_prior),
                    ("log_prob", log_prob)):
        check_f32(name, t, dev, (ntemps, nw))
    check_f32("betas", betas, dev, (ntemps,))
    if (counts.device != dev or counts.dtype != torch.int64
            or tuple(counts.shape) != (ntemps - 1,)
            or not counts.is_contiguous()):
        raise ValueError(f"counts must be a contiguous ({ntemps - 1},) "
                         f"int64 tensor on {dev}")
    if u is not None:
        step = _step(offset)  # injected draws: the parity is the host's
        check_f32("u", u, dev, (len(swap_pairs(step, ntemps, swap_every)),
                                nw))
    plan, table = swap_plan(nw, ntemps, device_sm_count(dev),
                            swap_leaves(leaves, ntemps, nw, dev))
    _launch(plan, coords, log_like, log_prior, log_prob, betas, counts,
            seed, offset, swap_every, u, table)
    count_launches(pt_swap)
    return None


def _launch(plan, coords, log_like, log_prior, log_prob, betas, counts, seed,
            offset, swap_every, u, table):
    """Launch the kernel with ``plan`` and leaf descriptors ``table`` (in
    :func:`swap_plan`'s order) on checked buffers."""
    ntemps, nw, nd = coords.shape
    dev = coords.device
    descs = (_SwapLeaf * max(1, len(table)))(*[_SwapLeaf(*d)
                                                for d in table])
    launch("pt_swap", dev, coords.data_ptr(), log_like.data_ptr(),
           log_prior.data_ptr(), log_prob.data_ptr(), betas.data_ptr(),
           counts.data_ptr(), ptr(u), ntemps, nw, nd, int(swap_every),
           plan.threads, *rng_args(_chain_seed(seed), offset, dev),
           ctypes.addressof(descs), len(table), plan.n_reg, plan.reg_unit)


pt_swap.launches = 0
pt_swap.device_launches = None
