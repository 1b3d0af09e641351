"""K5a: the differential-evolution proposal, as a CUDA kernel and as plain
PyTorch.

Held against ``emcee_tpu/moves/de.py:45-85`` (``DEMove.get_proposal``,
both pair modes).  The kernel is ``csrc/de_propose.cu``.  It is bound by
bytes (6 MB per launch at workload 3's shape; no matrix product, so no
tensor-core work), and tiled as K1 is (``_wrap.de_plan``): a block owns
a tile of consecutive walkers; one thread per walker draws its normal
and gamma (and in random mode its partner rows) into shared memory, one
spare lane per block makes the split's roll draw; then the block streams
the tile's own rows, both partner spans and ``q`` as float4 where every
row is 16-byte aligned.  Of the two variants measured on the card, the
one kept bulk-copies each tile's own rows into shared memory by TMA at
block start, overlapping phase A; the other reads them directly
(``PERF.md``).  K5a writes only
``q`` and a zero ``factor``; K2 (``ops/accept_kernel.py``) does the
rest.  The kernel uses the same Philox counters and the same
one-rounding-per-operation arithmetic as :func:`de_propose_plain`, so
the two agree bit for bit.

As for K1, the ensemble lives in one contiguous ``(nwalkers, ndim)``
buffer whose split groups are the row blocks ``[j*ng, (j+1)*ng)``; the
complement of block ``split`` is every other row, in row order (the
order of ``jnp.concatenate(c_parts)``), read in place.

Randomness comes from the Philox stream at ``(seed, offset)`` (see
``ops/philox.py``; ``offset`` is an int or a ``DeviceOffset``, and the
roll shifts come from the split's ``ROLL_LANE`` counter, drawn by the
kernel itself), or is injected (the parity mode):

* ``z`` ``(ng,)``: the walkers' standard normals (JAX: the first ``ng``
  of ``jax.random.normal(key, (ng + 2,))`` in roll mode, the
  ``key_g`` draw in random mode);
* roll mode: ``u_shift`` ``(2,)``, the two shift uniforms (JAX:
  ``norm.cdf`` of the last two normals);
* random mode: ``idx_a``, ``idx_b`` ``(ng,)`` int32, the two raw picks
  (JAX: the two ``randint`` draws, before ``j`` is moved past ``i``).

:func:`de_propose` launches the kernel for a CUDA tensor and uses
:func:`de_propose_plain` for a CPU tensor; it never falls back from one
to the other.  ``de_propose.launches`` counts kernel launches
(and ``de_propose.device_launches``, when set, on the card:
``_wrap.count_launches``).
"""

from __future__ import annotations

import numpy as np
import torch

from ._wrap import (
    PAIR_MODES, check_f32, check_i32, check_pair_mode, check_rows,
    complement_rows, count_launches, de_plan, device_sm_count, launch, ptr,
    rng_args)
from .philox import (
    PAIR_BLOCK, box_muller, roll_uniforms, to_uniform, walker_words)

__all__ = ["de_gamma0", "de_pairs", "de_propose", "de_propose_plain",
           "de_roll_shifts", "walker_normal"]


def de_gamma0(gamma0, ndim_global):
    """The mean stretch ``gamma0`` as float32, by default ``2.38 /
    sqrt(2 ndim)`` ("pure magic", ``de.py:49-52``), each operation
    rounded to float32 as the JAX package computes it."""
    if gamma0 is not None:
        return float(np.float32(gamma0))
    return float(np.float32(2.38) / np.sqrt(np.float32(2.0 * ndim_global)))


def de_roll_shifts(u1, u2, nc):
    """The two distinct roll shifts ``(s1, s2)``, 0-d int64 tensors, from
    two uniforms (float32 tensors or numbers), in float32 arithmetic as
    the kernel and ``de.py:65-67`` compute them."""
    u1 = torch.as_tensor(u1, dtype=torch.float32)
    u2 = torch.as_tensor(u2, dtype=torch.float32, device=u1.device)
    s1 = (u1 * nc).to(torch.int64) % nc
    d = 1 + (u2 * (nc - 1)).to(torch.int64)
    return s1, (s1 + d) % nc


def walker_normal(ng, split, seed, offset, device, dtype=torch.float32):
    """The walkers' standard normals of K5a: Box-Muller on words 0 and 2
    at ``(walker, split, offset)``."""
    w0, _, w2, _ = walker_words(ng, split, seed, offset, device)
    return box_muller(w0, w2, dtype)


def de_pairs(ng, nc, split, pair_mode, seed, offset, device, u_shift=None,
             idx_a=None, idx_b=None):
    """K5a's two complement indices ``(a, b)`` per walker, ``a != b``:
    the two roll shifts of the split (from ``u_shift`` or the split's
    ``ROLL_LANE`` words 0 and 1), or the two random picks (``idx_a``,
    ``idx_b`` or ``PAIR_BLOCK`` words 0 and 1), ``b`` moved past ``a``."""
    if pair_mode == "roll":
        if u_shift is None:
            u_shift = roll_uniforms(seed, split, offset, device)
        s1, s2 = de_roll_shifts(u_shift[0], u_shift[1], nc)
        lanes = torch.arange(ng, device=device)
        return (lanes + s1) % nc, (lanes + s2) % nc
    if idx_a is None:
        w = walker_words(ng, PAIR_BLOCK | split, seed, offset, device)
        a = torch.clamp((to_uniform(w[0]) * nc).to(torch.int64), max=nc - 1)
        b = torch.clamp((to_uniform(w[1]) * (nc - 1)).to(torch.int64),
                        max=nc - 2)
    else:
        a, b = idx_a.to(torch.int64), idx_b.to(torch.int64)
    return a, torch.where(b >= a, b + 1, b)


def de_propose_plain(coords, split, nsplits, *, gamma0, sigma, scale=None,
                     pair_mode, seed=0, offset=0, z=None, u_shift=None,
                     idx_a=None, idx_b=None):
    """Plain PyTorch K5a: returns ``(q (ng, ndim), factor (ng,))``.
    ``gamma0`` is the float32 value of :func:`de_gamma0`."""
    nw, _ = coords.shape
    ng = nw // nsplits
    lo = split * ng
    dev = coords.device
    if z is None:
        z = walker_normal(ng, split, seed, offset, dev, coords.dtype)
    a, b = de_pairs(ng, nw - ng, split, pair_mode, seed, offset, dev,
                    u_shift, idx_a, idx_b)
    ca = coords.index_select(0, complement_rows(a, split, ng))
    cb = coords.index_select(0, complement_rows(b, split, ng))
    s = coords[lo:lo + ng]
    # Python floats rounded to float32 first, as the kernel receives them.
    gamma0, sigma = float(np.float32(gamma0)), float(np.float32(sigma))
    g = gamma0 if scale is None else gamma0 * scale
    gamma = g * (1.0 + sigma * z)
    q = s + gamma[:, None] * (cb - ca)
    return q, torch.zeros(ng, dtype=coords.dtype, device=dev)


def de_propose(coords, split, nsplits, *, gamma0, sigma, scale=None,
               pair_mode, seed=0, offset=0, z=None, u_shift=None,
               idx_a=None, idx_b=None):
    """K5a on the tensor's device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Returns ``(q, factor)``."""
    kw = dict(gamma0=gamma0, sigma=sigma, scale=scale, pair_mode=pair_mode,
              seed=seed, offset=offset, z=z, u_shift=u_shift, idx_a=idx_a,
              idx_b=idx_b)
    if coords.device.type == "cpu":
        return de_propose_plain(coords, split, nsplits, **kw)
    if coords.device.type != "cuda":
        raise ValueError(f"no K5a kernel for device {coords.device}")
    check_pair_mode(pair_mode)
    _, nd, ng = check_rows(coords, split, nsplits)
    dev = coords.device
    check_f32("scale", scale, dev, ())
    check_f32("z", z, dev, (ng,))
    if pair_mode == "roll":
        check_f32("u_shift", u_shift, dev, (2,))
    elif (idx_a is None) != (idx_b is None):
        raise ValueError("inject both idx_a and idx_b, or neither")
    elif idx_a is not None:
        check_i32("idx_a", idx_a, dev, (ng,))
        check_i32("idx_b", idx_b, dev, (ng,))
    q = torch.empty((ng, nd), dtype=torch.float32, device=dev)
    factor = torch.empty((ng,), dtype=torch.float32, device=dev)
    # The staged variant wherever it can be (PERF.md).
    plan = de_plan(ng, nd, split, device_sm_count(dev), coords.data_ptr(),
                   q.data_ptr(), stage=True)
    _launch(plan, coords, q, factor, split, nsplits, **kw)
    count_launches(de_propose)
    return q, factor


def _launch(plan, coords, q, factor, split, nsplits, *, gamma0, sigma,
            scale, pair_mode, seed, offset, z, u_shift, idx_a, idx_b):
    """Launch K5a with launch plan ``plan`` on checked arguments."""
    dev = coords.device
    roll = pair_mode == "roll"
    launch(
        "de_propose", dev,
        coords.data_ptr(), q.data_ptr(), factor.data_ptr(),
        q.shape[0], coords.shape[1], split, nsplits, PAIR_MODES[pair_mode],
        float(gamma0), ptr(scale), float(sigma), ptr(z),
        ptr(u_shift if roll else None), ptr(None if roll else idx_a),
        ptr(None if roll else idx_b), *plan, *rng_args(seed, offset, dev),
    )


de_propose.launches = 0
de_propose.device_launches = None
