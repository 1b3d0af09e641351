"""What every kernel wrapper shares: its argument checks, the complement
row map, the Philox key and offset arguments, and the launch on the
current stream.

A wrapper checks device, type, shape and contiguity before it launches,
and raises on what its kernel does not take; the launch returns the C
entry point's ``cudaGetLastError()``, and a refused launch raises here.
The checks run on the host when a wrapper is called: once per recording
when the call is recorded into a CUDA graph, never per replay.
"""

from __future__ import annotations

import torch

from .philox import DeviceOffset

_MASK64 = 0xFFFFFFFFFFFFFFFF

#: pair mode name -> the kernels' code for it
PAIR_MODES = {"roll": 0, "random": 1}


def ptr(t):
    """A tensor's device pointer, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def check_f32(name, t, device, shape=None):
    """A contiguous float32 tensor on ``device`` (of ``shape``), or None."""
    if t is None:
        return
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(
            f"{name} must be float32 on {device}, got {t.dtype} on "
            f"{t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")


def check_i32(name, t, device, shape):
    if (t.device != device or t.dtype != torch.int32
            or not t.is_contiguous() or tuple(t.shape) != shape):
        raise ValueError(f"{name} must be a contiguous {shape} int32 tensor "
                         f"on {device}")


def check_rows(coords, split, nsplits):
    """The ensemble buffer and split as the kernels take them; returns
    ``(nwalkers, ndim, ng)``."""
    if coords.dim() != 2:
        raise ValueError("coords must be (nwalkers, ndim)")
    nw, nd = coords.shape
    if nsplits < 2 or nw % nsplits or not 0 <= split < nsplits:
        raise ValueError(f"bad split {split} of {nsplits} for {nw} walkers")
    if nw * nd >= 2**31:
        raise ValueError("ensemble too large for int32 indexing")
    check_f32("coords", coords, coords.device)
    return nw, nd, nw // nsplits


def check_pair_mode(pair_mode):
    if pair_mode not in PAIR_MODES:
        raise ValueError(f"unknown pair_mode: {pair_mode!r}")


def vec4_ok(nd, *tensors):
    """Whether 16-byte ``float4`` row accesses are valid: ``ndim % 4 == 0``
    and every buffer 16-byte aligned."""
    return nd % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def complement_rows(r, split, ng):
    """Complement index -> ensemble row: skip block ``split``'s rows, as
    the kernels do in place (``r + (r >= split*ng)*ng``)."""
    return torch.where(r >= split * ng, r + ng, r)


def rng_args(seed, offset, device):
    """The kernels' last three arguments before the stream: the 64-bit
    seed, the device offset word's pointer (None for an int offset) and
    the increment added to it."""
    if isinstance(offset, DeviceOffset):
        w = offset.word
        if w.device != device or w.dtype != torch.int64 or w.dim() != 0:
            raise ValueError(f"the offset word must be a 0-d int64 tensor "
                             f"on {device}")
        return int(seed) & _MASK64, w.data_ptr(), int(offset.inc) & _MASK64
    return int(seed) & _MASK64, None, int(offset) & _MASK64


def launch(name, device, *args):
    """Call kernel ``name``'s C entry point with ``args`` and the current
    stream of ``device``; raise if the launch was refused."""
    from ._build import library

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = library(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
