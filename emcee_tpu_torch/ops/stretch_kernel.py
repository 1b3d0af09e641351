"""K1: the stretch proposal, as a CUDA kernel and as plain PyTorch.

Held against ``emcee_tpu/moves/stretch.py:59-84``
(``StretchMove.get_proposal``, both pair modes) and the fused draw of
``emcee_tpu/moves/red_blue.py:138-148``.  The kernel is
``csrc/stretch_propose.cu``.  It is bound by bytes and latency (no
matrix product, no tensor-core work): 3.2 MB per launch at the main
path's shape.  A block owns a tile of consecutive walkers
(``_wrap.tile_plan``): each walker's thread draws its words, z and the
factor; one spare lane per block makes the split's roll draw; then the
block streams the tile's own rows and q as float4 spans and reads the
partner rows with neighbouring threads on neighbouring addresses.

The ensemble lives in one contiguous ``(nwalkers, ndim)`` buffer whose
split groups are the contiguous row blocks ``[j*ng, (j+1)*ng)``.  The
group being updated is block ``split``; its complement is every other
row, in row order, which is the order of ``jnp.concatenate(c_parts)``
in the JAX package.

The rung axis (parallel tempering): ``coords`` may be ``(T, nwalkers,
ndim)``, ``T`` ensembles of one ladder, and then ``q`` is ``(T, ng,
ndim)`` and ``factor`` ``(T, ng)``.  Rung ``r``'s complement is its own
other rows; it draws under its own key (``seed`` is then a
:class:`~.philox.RungKeys`), reads ``scale[r]`` of a ``(T,)`` scale and,
injected, its own rows of ``u_z`` / ``u_pair`` ``(T, ng)`` and
``u_shift[r]`` of a ``(T,)`` shift.  The kernel runs every rung in one
launch; the plain version draws every rung's words in one pass and does
the single-ensemble arithmetic elementwise over the rungs, so each rung
equals the same rung proposed alone.

Uniforms come from the Philox stream at ``(seed, offset)`` (see
``ops/philox.py``; ``offset`` is an int or a ``DeviceOffset``), or are
injected: ``u_z`` (ng,), and ``u_shift`` (0-d)
for roll pairs or ``u_pair`` (ng,) for random pairs.  Injection is the
parity mode, the counterpart of ``get_proposal(extra=)`` in the JAX
package.

:func:`stretch_propose` launches the kernel for a CUDA tensor and uses
:func:`stretch_propose_plain` for a CPU tensor; it never falls back from
one to the other.  ``stretch_propose.launches`` counts kernel launches
(and ``stretch_propose.device_launches``, when set, on the card:
``_wrap.count_launches``).
"""

from __future__ import annotations

import torch

from ._wrap import (
    PAIR_MODES, check_f32, check_pair_mode, check_rows, complement_rows,
    count_launches, device_sm_count, key_args, launch, ptr, rng_args,
    tile_plan)
from .philox import (
    RungKeys, roll_uniforms, rung_keys, rung_words, to_uniform, walker_words)

__all__ = ["PAIR_MODES", "stretch_propose", "stretch_propose_plain"]


def stretch_propose_plain(coords, split, nsplits, *, a, scale=None,
                          ndim_global, pair_mode, seed=0, offset=0,
                          u_z=None, u_pair=None, u_shift=None):
    """Plain PyTorch K1: returns ``(q (ng, ndim), factor (ng,))``, or on
    the rung axis ``(q (T, ng, ndim), factor (T, ng))``: every rung's
    words in one Philox pass under its own key
    (:func:`~.philox.rung_words`), then the same arithmetic elementwise
    over the rungs, so each rung equals the same rung proposed alone."""
    nw = coords.shape[-2]
    ng = nw // nsplits
    nc = nw - ng
    lo = split * ng
    dev = coords.device
    if u_z is None:
        if coords.dim() == 3:
            keys = seed if isinstance(seed, RungKeys) else rung_keys(
                seed, coords.shape[0], dev)
            w0, _, w2, _ = rung_words(keys, ng, split, offset, dev,
                                      roll=True, plain=True)
            u_shift = to_uniform(w0[:, ng])
            w0, w2 = w0[:, :ng], w2[:, :ng]
        else:
            w0, _, w2, _ = walker_words(ng, split, seed, offset, dev,
                                        plain=True)
            u_shift = roll_uniforms(seed, split, offset, dev, plain=True)[0]
        u_z = to_uniform(w0, coords.dtype)
        u_pair = to_uniform(w2, coords.dtype)
    if pair_mode == "roll":
        # int(u * nc) in float32, as moves/stretch.py:74 and the kernel.
        shift = (u_shift.to(torch.float32) * nc).to(torch.int64)
        r = (torch.arange(ng, device=dev) + shift[..., None]) % nc
    else:
        r = torch.clamp((u_pair.to(torch.float32) * nc).to(torch.int64),
                        max=nc - 1)
    cr = torch.take_along_dim(coords, complement_rows(r, split, ng)[..., None],
                              dim=-2)
    s = coords[..., lo:lo + ng, :]
    if scale is None:
        a_eff, am1 = a, a - 1.0
    else:
        a_eff = 1.0 + (a - 1.0) * scale[..., None]
        am1 = a_eff - 1.0
    t = am1 * u_z + 1.0
    z = t * t / a_eff
    factor = (ndim_global - 1.0) * torch.log(z)
    q = cr - (cr - s) * z[..., None]
    return q, factor


def stretch_propose(coords, split, nsplits, *, a, scale=None, ndim_global,
                    pair_mode, seed=0, offset=0, u_z=None, u_pair=None,
                    u_shift=None):
    """K1 on the tensor's device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Returns ``(q, factor)``."""
    kw = dict(a=a, scale=scale, ndim_global=ndim_global,
              pair_mode=pair_mode, seed=seed, offset=offset, u_z=u_z,
              u_pair=u_pair, u_shift=u_shift)
    if coords.device.type == "cpu":
        return stretch_propose_plain(coords, split, nsplits, **kw)
    if coords.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {coords.device}")
    check_pair_mode(pair_mode)
    _, nd, ng = check_rows(coords, split, nsplits, rungs=True)
    dev = coords.device
    lead = tuple(coords.shape[:-2])  # (T,) on the rung axis, else ()
    check_f32("scale", scale, dev, lead)
    if u_z is not None:
        check_f32("u_z", u_z, dev, lead + (ng,))
        if pair_mode == "roll":
            if u_shift is None:
                raise ValueError("roll mode with injected u_z needs u_shift")
            check_f32("u_shift", u_shift, dev, lead)
        else:
            if u_pair is None:
                raise ValueError("random mode with injected u_z needs u_pair")
            check_f32("u_pair", u_pair, dev, lead + (ng,))
    q = torch.empty(lead + (ng, nd), dtype=torch.float32, device=dev)
    factor = torch.empty(lead + (ng,), dtype=torch.float32, device=dev)
    rungs = lead[0] if lead else 1
    plan = tile_plan(ng, nd, split, device_sm_count(dev), coords.data_ptr(),
                     q.data_ptr(), rungs=rungs, nsplits=nsplits)
    _launch(plan, coords, q, factor, split, nsplits, **kw)
    count_launches(stretch_propose)
    return q, factor


def _launch(plan, coords, q, factor, split, nsplits, *, a, scale,
            ndim_global, pair_mode, seed, offset, u_z, u_pair, u_shift):
    """Launch K1 with launch plan ``plan`` on checked arguments."""
    dev = coords.device
    ntemps = coords.shape[0] if coords.dim() == 3 else 1
    launch(
        "stretch_propose", dev,
        coords.data_ptr(), q.data_ptr(), factor.data_ptr(),
        q.shape[-2], coords.shape[-1], split, nsplits,
        PAIR_MODES[pair_mode], float(a), float(a - 1.0), ptr(scale),
        float(ndim_global - 1.0), ptr(u_z), ptr(u_pair), ptr(u_shift),
        plan.tile, plan.grid, plan.vec,
        *key_args(seed, dev, ntemps, injected=u_z is not None),
        *rng_args(0, offset, dev)[1:],
    )


stretch_propose.launches = 0
stretch_propose.device_launches = None
