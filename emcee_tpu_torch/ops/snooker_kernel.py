"""K5b: the DE-snooker proposal, as a CUDA kernel and as plain PyTorch.

Held against ``emcee_tpu/moves/de_snooker.py:78-139``
(``DESnookerMove._draw_roll``, ``_draw_random`` and ``get_proposal``).
The kernel is ``csrc/snooker_propose.cu``.  It is bound by bytes (6 MB
per launch at workload 3's shape; no matrix product, so no tensor-core
work) and by the latency of its two row reductions.  It is tiled
(``_wrap.de_plan``): a block owns a tile of consecutive walkers; one
thread per walker (random mode) or one lane per block (roll mode) finds
the role rows; then one warp per walker loads its chunk of all four rows
before the first reduction, and reuses ``u = (s - z) / norm`` in the
projection and the update.

Per walker, three picks from the other split groups take the roles
``(z, z1, z2)``; then ``delta = s - z``, ``u = delta / |delta|``,
``q = s + u * gammas * (u . (z1 - z2))`` and the Metropolis factor
``(ndim - 1) (log|norm + gp| - log norm)``.  The groups are the
contiguous row blocks of the ensemble buffer, read in place.  Both row
sums run in one fixed order that depends on ``ndim`` alone
(:func:`row_sum`), in the kernel and in :func:`snooker_propose_plain`,
so the two agree bit for bit.

Randomness comes from the Philox stream at ``(seed, offset)`` (see
``ops/philox.py``; ``offset`` is an int or a ``DeviceOffset``, and the
roll picks come from the split's ``ROLL_LANE`` counter, drawn by the
kernel itself), or is injected (the parity mode):

* roll mode: ``u4`` ``(4,)``, the role-permutation uniform and the three
  shift uniforms (the JAX package's ``extra`` layout, ``de_snooker.py:81``);
* random mode (``nsplits=4``): ``idx`` ``(3, ng)`` int32, one pick in
  each other group, and ``perm`` ``(ng,)`` int32, the row of ``PERMS3``
  (JAX: the three ``randint`` draws and the permutation ``randint``).

:func:`snooker_propose` launches the kernel for a CUDA tensor and uses
:func:`snooker_propose_plain` for a CPU tensor; it never falls back from
one to the other.  ``snooker_propose.launches`` counts kernel launches
(and ``snooker_propose.device_launches``, when set, on the card:
``_wrap.count_launches``).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ._wrap import (
    PAIR_MODES, check_f32, check_i32, check_pair_mode, check_rows,
    count_launches, de_plan, device_sm_count, launch, ptr, rng_args)
from .philox import PAIR_BLOCK, roll_uniforms, to_uniform, walker_words

__all__ = ["PERMS3", "role_rows", "roll_picks", "row_sum", "snooker_propose",
           "snooker_propose_plain"]

#: the 3! role permutations, in ``itertools.permutations`` order
PERMS3 = tuple(itertools.permutations(range(3)))


def _pick_group(k, split, nsplits):
    """Group of pick ``k``: part ``k % (nsplits - 1)`` of the complement,
    skipping block ``split`` (``de_snooker.py:84``)."""
    g = k % (nsplits - 1)
    return g + (g >= split)


def roll_picks(u4, split, nsplits, ng):
    """``(groups, shifts)``, two ``(3,)`` int64 tensors, of the roles
    ``(z, z1, z2)`` from the four roll uniforms (a float32 tensor or
    numbers), in float32 arithmetic as the kernel and
    ``de_snooker.py:84-98`` compute them.  With ``nsplits=2`` the three
    picks keep their order (no role shuffle, ``:89-94``)."""
    u4 = torch.as_tensor(u4, dtype=torch.float32)
    k = torch.arange(3, device=u4.device)
    if nsplits > 2:
        p = torch.clamp((u4[0] * 6).to(torch.int64), max=5)
        k = torch.tensor(PERMS3, device=u4.device)[p]
    g = k % (nsplits - 1)
    return g + (g >= split).to(torch.int64), (u4[1 + k] * ng).to(torch.int64)


def role_rows(ng, split, nsplits, pair_mode, device, seed=0, offset=0,
              u4=None, idx=None, perm=None):
    """Ensemble rows ``(ng,)`` of the roles ``z``, ``z1``, ``z2``, from the
    stream or from the injected draws."""
    lanes = torch.arange(ng, device=device)
    if pair_mode == "roll":
        if u4 is None:
            u4 = roll_uniforms(seed, split, offset, device)
        groups, shifts = roll_picks(u4, split, nsplits, ng)
        return [groups[r] * ng + (lanes + shifts[r]) % ng for r in range(3)]
    if idx is None:
        w = walker_words(ng, PAIR_BLOCK | split, seed, offset, device)
        idx = [torch.clamp((to_uniform(w[k]) * ng).to(torch.int64),
                           max=ng - 1) for k in range(3)]
        perm = torch.clamp((to_uniform(w[3]) * 6).to(torch.int64), max=5)
    order = torch.tensor(PERMS3, device=device)[perm.to(torch.int64)]
    picks = torch.stack(
        [_pick_group(k, split, nsplits) * ng + idx[k].to(torch.int64)
         for k in range(3)], dim=1)
    return [picks.gather(1, order[:, r:r + 1])[:, 0] for r in range(3)]


def row_sum(terms):
    """The sum over the last axis of ``terms`` ``(n, ndim)``, in the
    kernel's order, which depends on ``ndim`` alone: lane ``l`` of a warp
    owns the 4-float chunks ``l, l+32, l+64, ...`` of the row (the terms
    are padded with +0.0 to a multiple of 128); a chunk sums as
    ``((a+b)+c)+d``; a lane adds its chunks in order to +0.0; the 32 lanes
    combine by the xor butterfly 16, 8, 4, 2, 1 (lane ``l`` adds lane
    ``l ^ o``; float addition commutes, so the halves below add the same
    pairs)."""
    n, nd = terms.shape
    m = -(-nd // 128)
    t = torch.nn.functional.pad(terms, (0, 128 * m - nd)).view(n, m, 32, 4)
    chunks = ((t[..., 0] + t[..., 1]) + t[..., 2]) + t[..., 3]
    acc = torch.zeros_like(chunks[:, 0])
    for k in range(m):
        acc = acc + chunks[:, k]
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, :h] + acc[:, h:]
    return acc[:, 0]


def snooker_propose_plain(coords, split, nsplits, *, gammas, scale=None,
                          ndim_global, pair_mode, seed=0, offset=0, u4=None,
                          idx=None, perm=None):
    """Plain PyTorch K5b: returns ``(q (ng, ndim), factor (ng,))``."""
    nw, _ = coords.shape
    ng = nw // nsplits
    lo = split * ng
    rows = role_rows(ng, split, nsplits, pair_mode, coords.device, seed,
                     offset, u4, idx, perm)
    z, z1, z2 = (coords.index_select(0, r) for r in rows)
    s = coords[lo:lo + ng]
    # gammas rounded to float32 first, as the kernel receives it.
    gammas = float(np.float32(gammas))
    gam = gammas if scale is None else gammas * scale
    delta = s - z
    norm = torch.sqrt(row_sum(delta * delta))
    u = delta / norm[:, None]
    proj = row_sum(u * (z1 - z2))
    gp = gam * proj
    q = s + u * gp[:, None]
    metropolis = torch.log(torch.abs(norm + gp)) - torch.log(norm)
    return q, (ndim_global - 1.0) * metropolis


def snooker_propose(coords, split, nsplits, *, gammas, scale=None,
                    ndim_global, pair_mode, seed=0, offset=0, u4=None,
                    idx=None, perm=None):
    """K5b on the tensor's device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Returns ``(q, factor)``."""
    kw = dict(gammas=gammas, scale=scale, ndim_global=ndim_global,
              pair_mode=pair_mode, seed=seed, offset=offset, u4=u4, idx=idx,
              perm=perm)
    if coords.device.type == "cpu":
        return snooker_propose_plain(coords, split, nsplits, **kw)
    if coords.device.type != "cuda":
        raise ValueError(f"no K5b kernel for device {coords.device}")
    check_pair_mode(pair_mode)
    _, nd, ng = check_rows(coords, split, nsplits)
    if nsplits != 4 and not (pair_mode == "roll" and nsplits == 2):
        raise ValueError("K5b needs nsplits=4 (or 2 in roll mode)")
    dev = coords.device
    check_f32("scale", scale, dev, ())
    if pair_mode == "roll":
        check_f32("u4", u4, dev, (4,))
    elif (idx is None) != (perm is None):
        raise ValueError("inject both idx and perm, or neither")
    elif idx is not None:
        check_i32("idx", idx, dev, (3, ng))
        check_i32("perm", perm, dev, (ng,))
    q = torch.empty((ng, nd), dtype=torch.float32, device=dev)
    factor = torch.empty((ng,), dtype=torch.float32, device=dev)
    plan = de_plan(ng, nd, split, device_sm_count(dev), coords.data_ptr(),
                   q.data_ptr(), snooker=True)
    _launch(plan, coords, q, factor, split, nsplits, **kw)
    count_launches(snooker_propose)
    return q, factor


def _launch(plan, coords, q, factor, split, nsplits, *, gammas, scale,
            ndim_global, pair_mode, seed, offset, u4, idx, perm):
    """Launch K5b with launch plan ``plan`` on checked arguments."""
    dev = coords.device
    roll = pair_mode == "roll"
    launch(
        "snooker_propose", dev,
        coords.data_ptr(), q.data_ptr(), factor.data_ptr(),
        q.shape[0], coords.shape[1], split, nsplits, PAIR_MODES[pair_mode],
        float(gammas), ptr(scale), float(ndim_global - 1.0),
        ptr(u4 if roll else None), ptr(None if roll else idx),
        ptr(None if roll else perm), *plan[:4],
        *rng_args(seed, offset, dev),
    )


snooker_propose.launches = 0
snooker_propose.device_launches = None
