"""K5a: the differential-evolution proposal, as a CUDA kernel and as plain
PyTorch.

Held against ``emcee_tpu/moves/de.py:45-85`` (``DEMove.get_proposal``,
both pair modes), and in its side mode against ``emcee_tpu/moves/side.py:
57-85`` (``SideMove.get_proposal``: ``q = s + (sigma / sqrt 2) z (c_j -
c_i)``, the same pairs and walker normal, no jitter).  The kernel is
``csrc/de_propose.cu``.  It is bound by
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

The rung axis (parallel tempering, as K1 has it): ``coords`` may be
``(T, nwalkers, ndim)``, ``T`` ensembles of one ladder, and then ``q`` is
``(T, ng, ndim)`` and ``factor`` ``(T, ng)``.  Rung ``r``'s complement is
its own other rows; it draws under its own key (``seed`` is then a
:class:`~.philox.RungKeys`) at the counters of one ensemble, reads
``scale[r]`` of a ``(T,)`` scale and, injected, its own rows of ``z``,
``idx_a``, ``idx_b`` ``(T, ng)`` and ``u_shift`` ``(T, 2)``.  The kernel
runs every rung in one launch; the plain version draws every rung's words
in one pass (:func:`~.philox.rung_words`) and does the one-ensemble
arithmetic elementwise over the rungs, so each rung equals the same rung
proposed alone, bit for bit.

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
    complement_rows, count_launches, de_plan, device_sm_count, key_args,
    launch, ptr, rng_args)
from .philox import (
    PAIR_BLOCK, RungKeys, box_muller, normals, roll_uniforms, row_uniforms,
    rung_keys, rung_words, to_uniform, walker_words)

__all__ = ["DE_MODES", "ROOT2_F32", "de_gamma0", "de_pairs", "de_propose",
           "de_propose_plain", "de_roll_shifts", "walker_normal"]

#: K5a's modes -> the kernel's code: the DE proposal (``gamma = gamma0
#: scale (1 + sigma z)``), or the side move's (``gamma = (gamma0 scale /
#: sqrt 2) z``, ``gamma0`` the side move's sigma, no jitter ``sigma``)
DE_MODES = {"de": 0, "side": 1}
#: sqrt(2) rounded to float32 (``jnp.sqrt(2.0)``), the side mode's divisor
ROOT2_F32 = float(np.float32(np.sqrt(2.0)))


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


def walker_normal(ng, split, seed, offset, device, dtype=torch.float32,
                  plain=False):
    """The walkers' standard normals of K5a: Box-Muller on words 0 and 2
    at ``(walker, split, offset)``: normal 0 of counter block ``split``
    (:func:`~.philox.normals`; K14 on the card, unless ``plain``).  Under
    a :class:`~.philox.RungKeys` ``seed``, ``(T, ng)``: rung ``r``'s row
    under its own key, from one :func:`~.philox.rung_words` pass (which
    the roll draws and K2 of the same split share)."""
    if isinstance(seed, RungKeys):
        w0, _, w2, _ = rung_words(seed, ng, split, offset, device, roll=True,
                                  plain=plain)
        return box_muller(w0[:, :ng], w2[:, :ng], dtype)
    if torch.device(device).type == "cpu":  # the shared CPU draw
        w0, _, w2, _ = walker_words(ng, split, seed, offset, device)
        return box_muller(w0, w2, dtype)
    return normals(ng, 1, seed, offset, device, dtype, block=split,
                   plain=plain)[:, 0]


def de_pairs(ng, nc, split, pair_mode, seed, offset, device, u_shift=None,
             idx_a=None, idx_b=None, plain=False):
    """K5a's two complement indices ``(a, b)`` per walker, ``a != b``:
    the two roll shifts of the split (from ``u_shift`` or the split's
    ``ROLL_LANE`` words 0 and 1), or the two random picks (``idx_a``,
    ``idx_b`` or ``PAIR_BLOCK`` words 0 and 1), ``b`` moved past ``a``.
    The draws are K14's on the card, unless ``plain``.  Under a
    :class:`~.philox.RungKeys` ``seed`` (or with ``(T, 2)`` / ``(T, ng)``
    injections), ``(T, ng)`` each, rung ``r``'s under its own key."""
    rungs = isinstance(seed, RungKeys)
    if pair_mode == "roll":
        if u_shift is None and rungs:
            w = rung_words(seed, ng, split, offset, device, roll=True,
                           plain=plain)
            u_shift = to_uniform(torch.stack((w[0][:, ng], w[1][:, ng]),
                                             dim=-1))
        elif u_shift is None:
            u_shift = roll_uniforms(seed, split, offset, device, plain=plain)
        s1, s2 = de_roll_shifts(u_shift[..., 0], u_shift[..., 1], nc)
        lanes = torch.arange(ng, device=device)
        return (lanes + s1[..., None]) % nc, (lanes + s2[..., None]) % nc
    if idx_a is None:
        if rungs:
            w = rung_words(seed, ng, PAIR_BLOCK | split, offset, device,
                           plain=plain)
            u = (to_uniform(w[0]), to_uniform(w[1]))
        elif torch.device(device).type == "cpu":  # the shared CPU draw
            w = walker_words(ng, PAIR_BLOCK | split, seed, offset, device)
            u = (to_uniform(w[0]), to_uniform(w[1]))
        else:
            u = row_uniforms(ng, 2, seed, offset, device,
                             block=PAIR_BLOCK | split, plain=plain).unbind(1)
        a = torch.clamp((u[0] * nc).to(torch.int64), max=nc - 1)
        b = torch.clamp((u[1] * (nc - 1)).to(torch.int64), max=nc - 2)
    else:
        a, b = idx_a.to(torch.int64), idx_b.to(torch.int64)
    return a, torch.where(b >= a, b + 1, b)


def _jitter(mode, sigma):
    """The DE jitter ``sigma`` as float32 for ``mode``: required by
    ``"de"``, refused by ``"side"`` (which has none; 0.0 is passed on)."""
    if mode not in DE_MODES:
        raise ValueError(f"unknown K5a mode: {mode!r}")
    if mode == "side":
        if sigma is not None:
            raise ValueError("the side mode takes no sigma (its gamma0 is "
                             "the side move's sigma)")
        return 0.0
    if sigma is None:
        raise ValueError("the de mode needs sigma")
    return float(np.float32(sigma))


def de_propose_plain(coords, split, nsplits, *, gamma0, sigma=None,
                     scale=None, pair_mode, seed=0, offset=0, z=None,
                     u_shift=None, idx_a=None, idx_b=None, mode="de"):
    """Plain PyTorch K5a: returns ``(q (ng, ndim), factor (ng,))``, or on
    the rung axis ``(q (T, ng, ndim), factor (T, ng))``: every rung's
    words in one Philox pass under its own key, then the same arithmetic
    elementwise over the rungs, so each rung equals the same rung
    proposed alone.  ``mode`` (:data:`DE_MODES`): ``"de"``, ``gamma0``
    the float32 value of :func:`de_gamma0` and ``sigma`` the jitter; or
    ``"side"``, ``gamma0`` the side move's sigma (``gamma = (gamma0 scale
    / sqrt 2) z``) and no ``sigma``."""
    sigma = _jitter(mode, sigma)
    nw = coords.shape[-2]
    ng = nw // nsplits
    lo = split * ng
    dev = coords.device
    if coords.dim() == 3 and not isinstance(seed, RungKeys):
        seed = rung_keys(seed, coords.shape[0], dev)
    # The pairs first: on the CPU the normals' draw (with the roll lane)
    # is then the last one kept, which K2's plain version of the split
    # reads again.
    a, b = de_pairs(ng, nw - ng, split, pair_mode, seed, offset, dev,
                    u_shift, idx_a, idx_b, plain=True)
    if z is None:
        z = walker_normal(ng, split, seed, offset, dev, coords.dtype,
                          plain=True)
    ca = torch.take_along_dim(coords, complement_rows(a, split, ng)[..., None],
                              dim=-2)
    cb = torch.take_along_dim(coords, complement_rows(b, split, ng)[..., None],
                              dim=-2)
    s = coords[..., lo:lo + ng, :]
    # Python floats rounded to float32 first, as the kernel receives them.
    gamma0 = float(np.float32(gamma0))
    if mode == "side":
        # Divisions by tensors only: on the card torch turns a division by
        # a Python number into a product by its reciprocal.
        g = torch.full((), gamma0, dtype=coords.dtype, device=dev)
        if scale is not None:
            g = g * scale[..., None]
        gamma = (g / torch.full((), ROOT2_F32, dtype=coords.dtype,
                                device=dev)) * z
    else:
        g = gamma0 if scale is None else gamma0 * scale[..., None]
        gamma = g * (1.0 + sigma * z)
    q = s + gamma[..., None] * (cb - ca)
    return q, torch.zeros(z.shape, dtype=coords.dtype, device=dev)


def de_propose(coords, split, nsplits, *, gamma0, sigma=None, scale=None,
               pair_mode, seed=0, offset=0, z=None, u_shift=None,
               idx_a=None, idx_b=None, mode="de"):
    """K5a on the tensor's device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Returns ``(q, factor)``.  Arguments
    as :func:`de_propose_plain`."""
    kw = dict(gamma0=gamma0, sigma=sigma, scale=scale, pair_mode=pair_mode,
              seed=seed, offset=offset, z=z, u_shift=u_shift, idx_a=idx_a,
              idx_b=idx_b, mode=mode)
    if coords.device.type == "cpu":
        return de_propose_plain(coords, split, nsplits, **kw)
    kw["sigma"] = _jitter(mode, sigma)
    if coords.device.type != "cuda":
        raise ValueError(f"no K5a kernel for device {coords.device}")
    check_pair_mode(pair_mode)
    _, nd, ng = check_rows(coords, split, nsplits, rungs=True)
    dev = coords.device
    lead = tuple(coords.shape[:-2])  # (T,) on the rung axis, else ()
    check_f32("scale", scale, dev, lead)
    check_f32("z", z, dev, lead + (ng,))
    if pair_mode == "roll":
        check_f32("u_shift", u_shift, dev, lead + (2,))
    elif (idx_a is None) != (idx_b is None):
        raise ValueError("inject both idx_a and idx_b, or neither")
    elif idx_a is not None:
        check_i32("idx_a", idx_a, dev, lead + (ng,))
        check_i32("idx_b", idx_b, dev, lead + (ng,))
    q = torch.empty(lead + (ng, nd), dtype=torch.float32, device=dev)
    factor = torch.empty(lead + (ng,), dtype=torch.float32, device=dev)
    # The staged variant wherever it can be (PERF.md).
    plan = de_plan(ng, nd, split, device_sm_count(dev), coords.data_ptr(),
                   q.data_ptr(), stage=True, rungs=lead[0] if lead else 1,
                   nsplits=nsplits)
    _launch(plan, coords, q, factor, split, nsplits, **kw)
    count_launches(de_propose)
    return q, factor


def _launch(plan, coords, q, factor, split, nsplits, *, gamma0, sigma,
            scale, pair_mode, seed, offset, z, u_shift, idx_a, idx_b,
            mode="de"):
    """Launch K5a with launch plan ``plan`` on checked arguments."""
    dev = coords.device
    roll = pair_mode == "roll"
    ntemps = coords.shape[0] if coords.dim() == 3 else 1
    injected = z is not None and (u_shift if roll else idx_a) is not None
    launch(
        "de_propose", dev,
        coords.data_ptr(), q.data_ptr(), factor.data_ptr(),
        q.shape[-2], coords.shape[-1], split, nsplits, PAIR_MODES[pair_mode],
        DE_MODES[mode], float(gamma0), ptr(scale), float(sigma), ptr(z),
        ptr(u_shift if roll else None), ptr(None if roll else idx_a),
        ptr(None if roll else idx_b), *plan,
        *key_args(seed, dev, ntemps, injected=injected),
        *rng_args(0, offset, dev)[1:],
    )


de_propose.launches = 0
de_propose.device_launches = None
