"""K11-K13: the gradient moves' fused chains, as CUDA kernels and as plain
PyTorch.

Held against ``emcee_tpu/moves/gradient.py``: the XLA-fused chains
around the gradient of ``MALAMove.propose`` (``:218-237``),
``HMCMove.propose`` (``:312-338``), ``ChEESHMCMove.propose``
(``:483-509``), ``EnsembleMALAMove.get_proposal`` (``:651-661``) and
``EnsembleHMCMove.get_proposal`` (``:740-761``).  The gradient itself is
the user's log-prob differentiated by ``torch.func.grad``; these three
kernels are what lies between the gradient evaluations.

* **K11, the Langevin step** (:func:`langevin_step`,
  ``csrc/langevin_step.cu``): the rows' standard normals ``z`` at
  ``NORMAL_BLOCK`` (the words and Box-Muller of
  :func:`~.philox.normals`), or an injected ``z``; with ``x`` given also
  the MALA proposal ``q = (x + (eps^2 / 2) d (d g)) + eps (d z)``, ``d``
  the preconditioner's diagonal (None for the identity).  Without ``x``
  it only draws: HMC's momenta, and the full preconditioners, whose
  products by ``L`` are ``torch.matmul``; their proposal is a second K11
  with ``g = (g L) L^T`` and the injected ``z = z L^T`` (the same
  arithmetic with ``d`` None).
* **K12, the Hastings / kinetic row reduction** (:func:`langevin_factor`,
  ``csrc/langevin_factor.cu``): per row, MALA's ``(sum z^2 - sum (-eps z
  - (eps^2 / 2) w)^2 / eps^2) / 2`` with ``w = d (b + c)`` (``b`` the
  gradient at ``x``, ``c`` at ``q``; ``c`` None takes ``w = b``, which
  the full preconditioners compute as ``(g_x + g_q) L``), or HMC's
  ``(sum p0^2 - sum pL^2) / 2``.  Each sum runs over the row's columns
  in order from +0.0, in the kernel and here, so the two agree bit for
  bit.
* **K13, the leapfrog step** (:func:`leapfrog`, ``csrc/leapfrog.cu``):
  ``kicks`` half-kicks ``p = p + (eps / 2) (d g)`` with one gradient (2
  between two evaluations: the closing half-kick of one step and the
  opening one of the next, added one after the other as the JAX scan
  adds them), then, with ``x`` given, the drift ``x = x + eps (d p)``.
  A full metric passes ``g L`` with ``d`` None for the kicks, then
  drifts by a second launch with ``p = p L^T`` and ``kicks=0``.  Its
  masked rung mode (``mask=``, a :class:`TripMask`; ChEES-HMC on a
  ladder) moves rung ``r``'s rows only while the device word ``trip`` is
  below ``more[r]``, and the launch that ends a trip (``advance``) adds
  one to ``trip`` (its grid's last block, by a done-counter).

Every operation rounds once (``__f*_rn`` in the kernels, no FMA), in the
JAX expression's order; ``eps`` is a 0-d float32 tensor on the rows'
device (``(T,)`` on the rung axis below: the tuned scale, step size and
jitter, never read on the host).
Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; it never falls back from one to the other, and
counts its launches in ``<wrapper>.launches`` (and in
``<wrapper>.device_launches``, when set, on the card:
``_wrap.count_launches``).

The rung axis (parallel tempering: ``emcee_tpu/parallel/tempering.py:538``
vmaps the chains over the ladder): every wrapper and plain version also
takes ``(T, n, ndim)`` rows, ``T`` ensembles of one ladder, with ``eps``
``(T,)`` (each rung's step size times its own tuned scale and jitter) and
K11's jitter ``v`` ``(T,)``.  One launch serves every rung (the grid's
second dimension the rung).  K11 draws rung ``r`` under its own key
(``seed`` a :class:`~.philox.RungKeys`; an int only where nothing is
drawn or ``T`` is 1) at the one-ensemble counters, so each rung equals
the one-ensemble launch under ``keys.seeds[r]``; the plain versions draw
every rung in one pass under ``keys.rounds`` (:func:`~.philox.normals`
and :func:`~.philox.grad_uniform` under a ``RungKeys``) and do the
one-ensemble arithmetic elementwise over the rungs, with no loop over
them.

K12 and K13 are bound by bytes (a few flops per element): at 1e5 x 5
float32 K12 moves 6 MB (three rows of inputs), K13 10 MB between two
gradients (x, p, g in; x, p out).  K11 moves 8 MB in MALA mode (x, g in;
z, q out) and issues about as long for its instructions (a Philox block
and two Box-Muller normals a pair of columns); its launch plan
(:func:`langevin_plan`) gives each block a tile of consecutive rows and
makes the grid one wave of the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ._wrap import (
    check_f32, count_launches, device_sm_count, key_args, launch, ptr,
    rng_args)
from .philox import GRAD_BLOCK, RungKeys, grad_uniform, normals, rung_keys

__all__ = ["LANGEVIN_BLOCKS_PER_SM", "LangevinPlan", "TripMask",
           "langevin_factor", "langevin_factor_plain", "langevin_plan",
           "langevin_step", "langevin_step_plain", "leapfrog",
           "leapfrog_plain", "trip_mask"]

#: K11's threads a block and the blocks an SM holds at once (kThreads and
#: kMinBlocks in csrc/langevin_step.cu, whose __launch_bounds__ keep the
#: registers to that)
LANGEVIN_THREADS = 256
LANGEVIN_BLOCKS_PER_SM = 3


class TripMask(NamedTuple):
    """K13's masked rung mode: which rungs a trip of a replayed loop
    steps.  ``more`` is each rung's trips (``(T,)`` int64), ``trip`` the
    trips run so far (a 0-d int64 device word) and ``done`` the kernel's
    done-counter (a 0-d int32 word, 0 between launches)."""

    more: torch.Tensor
    trip: torch.Tensor
    done: torch.Tensor


def trip_mask(more, trip):
    """A :class:`TripMask` of ``more`` and ``trip`` with a done-counter of
    its own."""
    return TripMask(more, trip, torch.zeros((), dtype=torch.int32,
                                            device=more.device))


class LangevinPlan(NamedTuple):
    """How K11 cuts its rows into blocks; the fields are the C entry
    point's arguments, in this order."""

    tile: int  #: consecutive rows a block
    grid: int  #: blocks, ``ceil(n / tile)`` (1 without rows: the jitter alone)


def langevin_plan(n, n_sm, rungs=1):
    """K11's launch plan for ``n`` rows on a card of ``n_sm`` SMs: the
    rows spread evenly over one wave, ``n_sm * LANGEVIN_BLOCKS_PER_SM``
    blocks (fewer where there are fewer rows), each a tile of ``ceil(n /
    blocks)`` consecutive rows.  With ``rungs`` > 1 (the rung axis) every
    rung's ``n`` rows count toward the wave: the tile is ``ceil(rungs * n /
    blocks)`` rows, and ``grid`` blocks (a rung's) run for each rung.  On the H100 that is 253 rows and 396
    blocks at the MALA stage's 1e5 rows, 13 rows and 385 blocks at
    ``EnsembleMALAMove``'s split of 5000.  Of one wave at 2-8 blocks an
    SM, 3 was the fastest at the MALA stage's shape; at 5000 rows 2 and
    4 were 3-4 % faster (``chip_smoke.py`` phase 13's tile sweep;
    ``PERF.md``).  The rows of a tile are one
    contiguous span of every operand and the kernel's accesses are 4-byte,
    so no base needs an alignment and no plan depends on one."""
    if n <= 0:
        return LangevinPlan(1, 1)
    tile = -(-(n * rungs) // (n_sm * LANGEVIN_BLOCKS_PER_SM))
    return LangevinPlan(tile, -(-n // tile))


def _per_rung(eps, k):
    """A ``(T,)`` rung-axis ``eps`` with ``k`` axes added, to broadcast
    over each rung's rows (a 0-d ``eps`` as it is)."""
    return eps if eps.dim() == 0 else eps.view(eps.shape + (1,) * k)


def _mala_q(x, g, z, eps, d):
    """``(x + (eps^2 / 2) d (d g)) + eps (d z)``, one rounding a step."""
    c = 0.5 * (eps * eps)
    if d is not None:
        g = (g * d) * d
        z = z * d
    return (x + c * g) + eps * z


def langevin_step_plain(shape, device, *, seed=0, offset=0, row0=0, z=None,
                        x=None, g=None, eps=None, d=None, v=None, v_split=0):
    """Plain PyTorch K11: ``(z, q)``, ``q`` None without ``x``; writes the
    jitter's ``v`` into ``v`` when given.  On the rung axis (``shape``
    ``(T, n, ndim)``) every rung's draws come from one pass under its own
    key (an int ``seed`` stands for :func:`~.philox.rung_keys` of it)."""
    n, nd = shape[-2:]
    if len(shape) == 3 and not isinstance(seed, RungKeys):
        seed = rung_keys(seed, shape[0], device)
    if v is not None:
        v.copy_(grad_uniform(seed, v_split, offset, device, plain=True)
                * 2.0 - 1.0)
    if z is None:
        z = normals(n, nd, seed, offset, device, row0=row0, plain=True)
    if x is None:
        return z, None
    return z, _mala_q(x, g, z, _per_rung(eps, 2), d)


def _check_rows(name, t, device, shape):
    """``t`` None or float32 rows of ``shape``: ``(n, ndim)``, or ``(T, n,
    ndim)`` on the rung axis."""
    if len(shape) not in (2, 3):
        raise ValueError(f"{name} must be (rows, ndim) or (rungs, rows, "
                         "ndim)")
    check_f32(name, t, device, shape)


def _lead(shape):
    """``(T,)`` of a rung-axis shape, ``()`` of one ensemble's; raises
    for anything else."""
    if len(shape) not in (2, 3) or (len(shape) == 3
                                    and not 1 <= shape[0] < 65536):
        raise ValueError(f"rows must be (n, ndim) or (T, n, ndim) with 1 "
                         f"to 65535 rungs, got {tuple(shape)}")
    return tuple(int(s) for s in shape[:-2])


def langevin_step(shape, device, *, seed=0, offset=0, row0=0, z=None,
                  x=None, g=None, eps=None, d=None, v=None, v_split=0):
    """K11 for ``shape = (n, ndim)`` rows on ``device``: the CUDA kernel on
    a CUDA device, the plain version on the CPU.  The normals are rows
    ``row0 .. row0 + n - 1`` of the ``(seed, offset)`` stream unless ``z``
    injects them.  With ``v``, a 0-d float32 tensor, the same launch
    writes into it the HMC moves' step-size jitter ``2 u - 1`` of split
    ``v_split`` (:func:`~.philox.grad_uniform`).  On the rung axis
    (``shape`` ``(T, n, ndim)``) every row argument is ``(T, n, ndim)``,
    ``eps`` and ``v`` are ``(T,)`` and ``seed`` the rungs'
    :class:`~.philox.RungKeys` (where anything is drawn and ``T`` > 1).
    Returns ``(z, q)``; ``q`` is None without ``x``."""
    device = torch.device(device)
    kw = dict(seed=seed, offset=offset, row0=row0, z=z, x=x, g=g, eps=eps,
              d=d, v=v, v_split=v_split)
    if device.type == "cpu":
        return langevin_step_plain(shape, device, **kw)
    if device.type != "cuda":
        raise ValueError(f"no K11 kernel for device {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    lead = _lead(shape)
    shape = lead + tuple(int(s) for s in shape[-2:])
    n, nd = shape[-2:]
    ntemps = lead[0] if lead else 1
    if ntemps * n * nd >= 2**31 or row0 < 0 or row0 + n >= 2**31:
        raise ValueError("rows out of range for K11's counters")
    _check_rows("z", z, device, shape)
    if x is not None:
        _check_rows("x", x, device, shape)
        if g is None or eps is None:
            raise ValueError("K11's MALA mode needs g and eps")
        _check_rows("g", g, device, shape)
    check_f32("eps", eps, device, lead)
    check_f32("d", d, device, (nd,))
    check_f32("v", v, device, lead)
    # Refuses here, before any allocation, rungs that draw without keys.
    key_args(seed, device, ntemps, injected=z is not None and v is None)
    z_out = None
    if z is None:
        z_out = z = torch.empty(shape, dtype=torch.float32, device=device)
    q = None if x is None else torch.empty_like(x)
    if n or v is not None:
        # Injected z and no x: no row has work, only the jitter.
        rows = n if z_out is not None or x is not None else 0
        _launch(langevin_plan(rows, device_sm_count(device), ntemps), device,
                x, g, d, eps, None if z_out is not None else z, z_out, q, v,
                v_split, n, nd, row0, seed, offset, ntemps)
        count_launches(langevin_step)
    return z, q


def _launch(plan, device, x, g, d, eps, z_in, z_out, q, v, v_split, n, nd,
            row0, seed, offset, ntemps=1):
    """Launch K11 with launch plan ``plan`` on checked arguments (``ntemps``
    rungs of ``n`` rows; ``seed`` an int or a :class:`~.philox.RungKeys`)."""
    launch("langevin_step", device, ptr(x), ptr(g), ptr(d), ptr(eps),
           ptr(z_in), ptr(z_out), ptr(q), ptr(v), GRAD_BLOCK | int(v_split),
           n, nd, int(row0), *plan,
           *key_args(seed, device, ntemps, injected=True),
           *rng_args(0, offset, device)[1:])


langevin_step.launches = 0
langevin_step.device_launches = None


def _row_sums(*terms):
    """Each ``(..., n, ndim)`` term summed over its rows, column by column
    from +0.0 (the kernel's order)."""
    out = []
    for t in terms:
        acc = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
        for j in range(t.shape[-1]):
            acc = acc + t[..., j]
        out.append(acc)
    return out


def langevin_factor_plain(a, b, c=None, *, eps=None, d=None):
    """Plain PyTorch K12: ``(n,)`` (``(T, n)`` on the rung axis).  Without
    ``eps`` the kinetic term ``(sum a^2 - sum b^2) / 2``; with it MALA's
    Hastings factor of ``z = a`` and ``w = d (b + c)``."""
    if eps is None:
        s1, s2 = _row_sums(a * a, b * b)
        return 0.5 * (s1 - s2)
    w = b if c is None else b + c
    if d is not None:
        w = w * d
    e = _per_rung(eps, 2)
    r = (-e) * a - (0.5 * (e * e)) * w
    s1, s2 = _row_sums(a * a, r * r)
    e = _per_rung(eps, 1)
    return (s1 - s2 / (e * e)) / 2.0


def langevin_factor(a, b, c=None, *, eps=None, d=None):
    """K12 on the rows' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns the ``(n,)`` factors (``(T, n)`` of
    ``(T, n, ndim)`` rows and a ``(T,)`` ``eps``)."""
    dev = a.device
    kw = dict(eps=eps, d=d)
    if dev.type == "cpu":
        return langevin_factor_plain(a, b, c, **kw)
    if dev.type != "cuda":
        raise ValueError(f"no K12 kernel for device {dev}")
    lead = _lead(a.shape)
    n, nd = a.shape[-2:]
    ntemps = lead[0] if lead else 1
    if ntemps * n * nd >= 2**31:
        raise ValueError("rows too many for int32 indexing")
    for name, t in (("a", a), ("b", b), ("c", c)):
        _check_rows(name, t, dev, tuple(a.shape))
    check_f32("eps", eps, dev, lead)
    check_f32("d", d, dev, (nd,))
    if eps is None and (c is not None or d is not None):
        raise ValueError("K12's kinetic mode takes a and b only")
    out = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    if n:
        launch("langevin_factor", dev, a.data_ptr(), b.data_ptr(), ptr(c),
               ptr(d), ptr(eps), out.data_ptr(), n, nd, ntemps)
        count_launches(langevin_factor)
    return out


langevin_factor.launches = 0
langevin_factor.device_launches = None


def leapfrog_plain(p, g, eps, *, d=None, kicks=1, x=None, x_out=None,
                   p_out=None, mask=None, advance=True):
    """Plain PyTorch K13, writing the kernel's outputs; returns ``(x_out,
    p_out)`` (``x_out`` None without ``x``; ``p`` itself when
    ``kicks=0``).  On the rung axis ``eps`` is ``(T,)``; with ``mask`` (a
    :class:`TripMask`) only the rungs with ``trip < more`` are written,
    and ``advance`` adds one to ``trip``."""
    live = None if mask is None else (mask.trip < mask.more)[:, None, None]

    def put(out, new):
        out.copy_(new if live is None else torch.where(live, new, out))

    eps = _per_rung(eps, 2)
    if kicks:
        lt = g if d is None else g * d
        hk = (0.5 * eps) * lt
        pk = p + hk
        if kicks == 2:
            pk = pk + hk
        p_out = p if p_out is None else p_out
        put(p_out, pk)
    else:
        pk = p_out = p
    if x is not None:
        lp = pk if d is None else pk * d
        x_out = x if x_out is None else x_out
        put(x_out, x + eps * lp)
    if mask is not None and advance:
        mask.trip.add_(1)
    return (None if x is None else x_out), p_out


def leapfrog(p, g, eps, *, d=None, kicks=1, x=None, x_out=None, p_out=None,
             mask=None, advance=True):
    """K13 on the rows' device: ``kicks`` (0, 1 or 2) half-kicks of ``p``
    by ``g`` into ``p_out`` (in place by default), then with ``x`` the
    drift into ``x_out`` (in place by default).  The CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  On the rung axis the rows
    are ``(T, n, ndim)`` and ``eps`` is ``(T,)``; ``mask`` (a
    :class:`TripMask` of the ``T`` rungs) takes the masked rung mode, in
    which ``advance`` ends the trip.  Returns ``(x_out, p_out)``."""
    dev = p.device
    kw = dict(d=d, kicks=kicks, x=x, x_out=x_out, p_out=p_out, mask=mask,
              advance=advance)
    if dev.type == "cpu":
        return leapfrog_plain(p, g, eps, **kw)
    if dev.type != "cuda":
        raise ValueError(f"no K13 kernel for device {dev}")
    if kicks not in (0, 1, 2):
        raise ValueError("kicks must be 0, 1 or 2")
    lead = _lead(p.shape)
    shape = tuple(p.shape)
    n, nd = shape[-2:]
    ntemps = lead[0] if lead else 1
    if ntemps * n * nd >= 2**31:
        raise ValueError("rows too many for int32 indexing")
    _check_rows("p", p, dev, shape)
    check_f32("eps", eps, dev, lead)
    check_f32("d", d, dev, (nd,))
    if kicks:
        if g is None:
            raise ValueError("a kick needs g")
        _check_rows("g", g, dev, shape)
        p_out = p if p_out is None else p_out
        _check_rows("p_out", p_out, dev, shape)
    else:
        p_out = None
    if x is not None:
        _check_rows("x", x, dev, shape)
        x_out = x if x_out is None else x_out
        _check_rows("x_out", x_out, dev, shape)
    elif kicks == 0:
        raise ValueError("K13 with no kick and no drift does nothing")
    else:
        x_out = None
    if mask is not None:
        _check_mask(mask, dev, lead)
        if n:
            launch("leapfrog_masked", dev, ptr(x), ptr(x_out), p.data_ptr(),
                   ptr(p_out), ptr(g if kicks else None), ptr(d),
                   eps.data_ptr(), n, nd, int(kicks), ntemps,
                   mask.more.data_ptr(), mask.trip.data_ptr(),
                   mask.done.data_ptr(), int(bool(advance)))
            count_launches(leapfrog)
        elif advance:
            mask.trip.add_(1)
    elif n:
        launch("leapfrog", dev, ptr(x), ptr(x_out), p.data_ptr(),
               ptr(p_out), ptr(g if kicks else None), ptr(d), eps.data_ptr(),
               n, nd, int(kicks), ntemps)
        count_launches(leapfrog)
    return x_out, p if p_out is None else p_out


def _check_mask(mask, dev, lead):
    """A :class:`TripMask` of the ``lead = (T,)`` rungs on ``dev``."""
    if not lead:
        raise ValueError("the masked rung mode takes (T, n, ndim) rows")
    for name, t, dt, shape in (("more", mask.more, torch.int64, lead),
                               ("trip", mask.trip, torch.int64, ()),
                               ("done", mask.done, torch.int32, ())):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"the mask's {name} must be a contiguous {shape}"
                             f" {dt} tensor on {dev}")


leapfrog.launches = 0
leapfrog.device_launches = None
