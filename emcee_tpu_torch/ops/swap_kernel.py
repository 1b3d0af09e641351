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
``torch.where`` and the kernel agree bit for bit.  One launch takes up to
``SWAP_LEAVES`` leaves; more raise.

:func:`pt_swap` launches the kernel for CUDA tensors and uses
:func:`pt_swap_plain` for CPU tensors; it never falls back from one to
the other.  ``pt_swap.launches`` counts kernel launches (and
``pt_swap.device_launches``, when set, on the card:
``_wrap.count_launches``).
"""

from __future__ import annotations

import ctypes

import torch

from ._wrap import check_f32, count_launches, launch, ptr, rng_args
from .philox import (
    SWAP_BLOCK, RungKeys, philox4x32, split_key, split_offset, to_uniform)
from .philox import _cpu_offset as _step  # a device word is read: a sync

__all__ = ["SWAP_LEAVES", "SWAP_THREADS", "pt_swap", "pt_swap_plain",
           "swap_leaves", "swap_pairs", "tempered_log_prob"]

#: threads a block of the kernel (kThreads in csrc/pt_swap.cu)
SWAP_THREADS = 128
#: user blob leaves one launch exchanges (kMaxLeaves in csrc/pt_swap.cu)
SWAP_LEAVES = 16


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
    if len(out) > SWAP_LEAVES:
        raise ValueError(f"K15 exchanges at most {SWAP_LEAVES} blob leaves "
                         f"a launch, got {len(out)}")
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
    table = swap_leaves(leaves, ntemps, nw, dev)
    descs = (_SwapLeaf * max(1, len(table)))(*[_SwapLeaf(*d)
                                                for d in table])
    launch("pt_swap", dev, coords.data_ptr(), log_like.data_ptr(),
           log_prior.data_ptr(), log_prob.data_ptr(), betas.data_ptr(),
           counts.data_ptr(), ptr(u), ntemps, nw, nd, int(swap_every),
           *rng_args(_chain_seed(seed), offset, dev),
           ctypes.addressof(descs), len(table))
    count_launches(pt_swap)
    return None


pt_swap.launches = 0
pt_swap.device_launches = None
