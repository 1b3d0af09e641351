"""K20: the blended move's choice and select, as a CUDA kernel and as
plain PyTorch.

Held against ``emcee_tpu/moves/blended.py:87-120`` (``BlendedMove.
get_proposal``: a categorical draw over the weights, then
``jnp.stack(qs)[idx]`` and ``jnp.stack(fs)[idx]``), vmapped over a ladder
by ``emcee_tpu/parallel/tempering.py:538``.  The kernel is
``csrc/blend_select.cu``, one launch a split: a block's first thread draws
the split's uniform, word 0 at ``(ROLL_LANE, BLEND_BLOCK | split,
offset)`` under the key (each rung's own on the rung axis), and counts the
CDF points at or below it, which are float32: the same points the plain
``u >= c`` compares a float32 uniform with; then the block copies the
chosen sub-move's ``q`` rows and factor.  A factor of one value broadcasts
over the split's walkers.

On the rung axis every candidate ``q`` is ``(T, ng, nd)``, every factor
``(T, ng)`` (or one value), and ``seed`` the keys of the blend (the rungs'
:class:`~.philox.RungKeys`): rung ``r`` chooses under its own key, as it
would alone.

:func:`blend_select` launches the kernel for CUDA tensors and runs
:func:`blend_select_plain` for CPU tensors; it never falls back, and
counts its launches in ``blend_select.launches`` (and
``blend_select.device_launches`` when set: ``_wrap.count_launches``).  The
plain version equals the kernel bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._wrap import check_f32, count_launches, key_args, launch, rng_args
from .philox import BLEND_BLOCK, ROLL_LANE, RungKeys, rung_keys, word_uniforms

__all__ = ["MAX_MOVES", "blend_choice", "blend_select", "blend_select_plain"]

#: the sub-moves one launch chooses among (EMCEE_BLEND_MAX in
#: csrc/blend_select.cu)
MAX_MOVES = 16
#: threads a block, and the elements a thread copies at least
THREADS = 256
_PER_THREAD = 4


def blend_choice(u, cdf):
    """The sub-move index of uniforms ``u``: the count of the CDF points
    ``cdf`` (Python floats, compared in ``u``'s float32) at or below
    ``u``."""
    idx = torch.zeros(u.shape, dtype=torch.int64, device=u.device)
    for c in cdf:
        idx = idx + (u >= c).to(torch.int64)
    return idx


def _lead(qs):
    q0 = qs[0]
    if q0.dim() not in (2, 3):
        raise ValueError("q must be (ng, ndim) or (T, ng, ndim)")
    return tuple(int(t) for t in q0.shape[:-2]), int(q0.shape[-2])


def blend_select_plain(qs, fs, cdf, seed, offset, split, choice=None):
    """Plain PyTorch K20: ``(q, factor)`` of the sub-move each rung chooses
    among the candidates ``qs`` (``(ng, nd)`` or ``(T, ng, nd)`` each) and
    ``fs`` (``(..., ng)`` each, or one value), by the CDF points ``cdf``
    (``len(qs) - 1`` Python floats) at the split's uniform under ``seed``
    at ``offset``.  ``choice`` (an int, or ``()`` / ``(T,)`` int64) injects
    the choice."""
    lead, ng = _lead(qs)
    dev = qs[0].device
    if choice is None:
        if lead and not isinstance(seed, RungKeys):
            seed = rung_keys(seed, lead[0], dev)
        u = word_uniforms(1, 1, BLEND_BLOCK | split, seed, offset, dev,
                          row0=ROLL_LANE, plain=True).reshape(lead)
        choice = blend_choice(u, cdf)
    choice = torch.as_tensor(choice, device=dev)
    q, f = qs[0], fs[0].expand(lead + (ng,))
    for k in range(1, len(qs)):
        pick = choice == k
        q = torch.where(pick[..., None, None], qs[k], q)
        f = torch.where(pick[..., None], fs[k].expand(lead + (ng,)), f)
    return q, f


class _Args(ctypes.Structure):
    """The arguments of the entry point (``BlendArgs`` in
    ``csrc/blend_select.cu``, field for field)."""

    _fields_ = [("q", ctypes.c_void_p * MAX_MOVES),
                ("f", ctypes.c_void_p * MAX_MOVES),
                ("cdf", ctypes.c_float * (MAX_MOVES - 1))] + [
        (name, ctypes.c_void_p) for name in (
            "q_out", "f_out", "choice_in", "offset_dev", "keys")
    ] + [("offset_inc", ctypes.c_ulonglong), ("seed", ctypes.c_ulonglong)] + [
        (name, ctypes.c_int) for name in (
            "f_scalar", "k", "ng", "nd", "ntemps", "split", "choice",
            "threads", "blocks")]


def blend_select(qs, fs, cdf, seed, offset, split, choice=None):
    """K20 on the candidates' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Arguments as
    :func:`blend_select_plain`."""
    dev = qs[0].device
    if dev.type == "cpu":
        return blend_select_plain(qs, fs, cdf, seed, offset, split, choice)
    if dev.type != "cuda":
        raise ValueError(f"no K20 kernel for device {dev}")
    lead, ng = _lead(qs)
    nd = int(qs[0].shape[-1])
    k = len(qs)
    if not 2 <= k <= MAX_MOVES or len(fs) != k or len(cdf) != k - 1:
        raise ValueError(f"K20 chooses among 2 to {MAX_MOVES} sub-moves, "
                         f"got {k} proposals, {len(fs)} factors and "
                         f"{len(cdf)} CDF points")
    if ng * nd * (lead[0] if lead else 1) >= 2**31 or (
            lead and not 1 <= lead[0] < 65536):
        raise ValueError(f"bad K20 shape {tuple(qs[0].shape)}")
    scalar = 0
    for j, (q, f) in enumerate(zip(qs, fs)):
        check_f32("q", q, dev, lead + (ng, nd))
        if f.numel() == 1 and tuple(f.shape) != lead + (ng,):
            scalar |= 1 << j
            check_f32("factor", f, dev)
        else:
            check_f32("factor", f, dev, lead + (ng,))
    ntemps = lead[0] if lead else 1
    choice_in = const = None
    if isinstance(choice, torch.Tensor):
        if (choice.device != dev or choice.dtype != torch.int64
                or tuple(choice.shape) != lead
                or not choice.is_contiguous()):
            raise ValueError(f"choice must be a contiguous {lead} int64 "
                             f"tensor on {dev}")
        choice_in = choice.data_ptr()
    elif choice is not None:
        const = int(choice)
    ntemps, keys, seed64 = key_args(seed, dev, ntemps,
                                    injected=choice is not None)
    _, off_ptr, off = rng_args(0, offset, dev)
    q_out = torch.empty(lead + (ng, nd), dtype=torch.float32, device=dev)
    f_out = torch.empty(lead + (ng,), dtype=torch.float32, device=dev)
    pad = [None] * (MAX_MOVES - k)
    args = _Args(
        q=(ctypes.c_void_p * MAX_MOVES)(*[q.data_ptr() for q in qs], *pad),
        f=(ctypes.c_void_p * MAX_MOVES)(*[f.data_ptr() for f in fs], *pad),
        cdf=(ctypes.c_float * (MAX_MOVES - 1))(
            *[float(np.float32(c)) for c in cdf]),
        q_out=q_out.data_ptr(), f_out=f_out.data_ptr(), choice_in=choice_in,
        offset_dev=off_ptr, keys=keys, offset_inc=off, seed=seed64,
        f_scalar=scalar, k=k, ng=ng, nd=nd, ntemps=ntemps, split=int(split),
        choice=-1 if const is None else (const if const >= 0 else k),
        threads=THREADS,
        blocks=max(1, -(-ng * nd // (THREADS * _PER_THREAD))))
    launch("blend_select", dev, ctypes.addressof(args))
    count_launches(blend_select)
    return q_out, f_out


blend_select.launches = 0
blend_select.device_launches = None
