"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, which
is loaded with ``ctypes``.  That keeps PyTorch's headers out of the
build (seconds, where ``torch.utils.cpp_extension.load`` takes minutes).
Libraries go to ``build/kernels/`` beside the package (the directory is
git-ignored); each file name carries a hash of its sources and flags, so
an edited source is rebuilt and never mixed with a stale library.

Nothing is built when this module is imported: a kernel is built on its
first use, or all of them at once by :func:`build_all`, which starts one
``nvcc`` per source in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["KERNELS", "build_all", "build_dir", "library"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_HEADERS = ("bulk_copy.cuh", "philox.cuh")

#: kernel name -> (source file, C entry point); kernels of one source
#: share its library
KERNELS = {
    "stretch_propose": ("stretch_propose.cu", "emcee_stretch_propose"),
    "accept_select": ("accept_select.cu", "emcee_accept_select"),
    "accept_rungs": ("accept_select.cu", "emcee_accept_rungs"),
    "de_propose": ("de_propose.cu", "emcee_de_propose"),
    "snooker_propose": ("snooker_propose.cu", "emcee_snooker_propose"),
    "langevin_step": ("langevin_step.cu", "emcee_langevin_step"),
    "langevin_factor": ("langevin_factor.cu", "emcee_langevin_factor"),
    "leapfrog": ("leapfrog.cu", "emcee_leapfrog"),
    "pt_swap": ("pt_swap.cu", "emcee_pt_swap"),
    "philox_draw": ("philox_draw.cu", "emcee_philox_draw"),
}

_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_ARGTYPES = {
    "stretch_propose": [
        _P, _P, _P,  # coords, q, factor
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # ng nd split nsplits
        ctypes.c_int,  # pair_mode
        ctypes.c_float, ctypes.c_float, _P,  # a, a - 1, scale
        ctypes.c_float,  # ndim_global - 1
        _P, _P, _P,  # u_z, u_pair, u_shift
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # plan: tile grid vec
        ctypes.c_int, _P,  # ntemps, the rungs' key table
        ctypes.c_ulonglong, _P, ctypes.c_ulonglong,  # seed, offset_dev, offset
        _P,  # stream
    ],
    "accept_select": [
        _P, _P, _P, _P, _P, _P, _P, _P,  # q factor lp_q coords lp acc count log_u
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # ng nd split
        *[ctypes.c_int] * 5,  # plan: tile grid vec stage smem
        ctypes.c_ulonglong, _P, ctypes.c_ulonglong,  # seed, offset_dev, offset
        _P, ctypes.c_int,  # blob leaves (host array), their number
        ctypes.c_int,  # row_unit: leaves of one 4- or 8-byte unit a row
        _P,  # stream
    ],
    "accept_rungs": [
        _P, _P, _P, _P, _P, _P, _P, _P,  # q factor lp_q coords lp acc count log_u
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # ng nd split
        ctypes.c_int, ctypes.c_int,  # rung stride nw, ntemps
        ctypes.c_int, ctypes.c_int,  # plan: threads reg_row
        _P, ctypes.c_ulonglong,  # the rungs' key table, seed
        _P, ctypes.c_ulonglong,  # offset_dev, offset
        _P, ctypes.c_int,  # blob leaves (host array), their number
        ctypes.c_int,  # the leading leaves that go through registers
        _P,  # stream
    ],
    "de_propose": [
        _P, _P, _P,  # coords, q, factor
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # ng nd split nsplits
        ctypes.c_int,  # pair_mode
        ctypes.c_float, _P, ctypes.c_float,  # gamma0, scale, sigma
        _P, _P, _P, _P,  # z, u_shift, idx_a, idx_b
        *[ctypes.c_int] * 6,  # plan: tile grid threads vec stage smem
        ctypes.c_int, _P,  # ntemps, the rungs' key table
        ctypes.c_ulonglong, _P, ctypes.c_ulonglong,  # seed, offset_dev, offset
        _P,  # stream
    ],
    "snooker_propose": [
        _P, _P, _P,  # coords, q, factor
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # ng nd split nsplits
        ctypes.c_int,  # pair_mode
        ctypes.c_float, _P, ctypes.c_float,  # gammas, scale, ndim_global - 1
        _P, _P, _P,  # u4, idx, perm
        *[ctypes.c_int] * 4,  # plan: tile grid threads vec
        ctypes.c_int, _P,  # ntemps, the rungs' key table
        ctypes.c_ulonglong, _P, ctypes.c_ulonglong,  # seed, offset_dev, offset
        _P,  # stream
    ],
    "langevin_step": [
        _P, _P, _P, _P,  # x, g, d, eps
        _P, _P, _P,  # z_in, z_out, q
        _P, ctypes.c_uint,  # v_out, v_block
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n nd row0
        ctypes.c_int, ctypes.c_int,  # plan: tile grid
        ctypes.c_int, _P,  # ntemps, the rungs' key table
        ctypes.c_ulonglong, _P, ctypes.c_ulonglong,  # seed, offset_dev, offset
        _P,  # stream
    ],
    "langevin_factor": [
        _P, _P, _P, _P, _P, _P,  # a, b, c, d, eps, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n nd ntemps
        _P,  # stream
    ],
    "leapfrog": [
        _P, _P, _P, _P,  # x_in, x_out, p_in, p_out
        _P, _P, _P,  # g, d, eps
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n nd kicks
        ctypes.c_int,  # ntemps
        _P,  # stream
    ],
    "pt_swap": [
        _P, _P, _P, _P,  # coords, log_like, log_prior, log_prob
        _P, _P, _P,  # betas, counts, u
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # ntemps nw nd
        ctypes.c_int, ctypes.c_int,  # swap_every, plan: threads
        ctypes.c_ulonglong, _P, ctypes.c_ulonglong,  # seed, offset_dev, offset
        _P, ctypes.c_int,  # user blob leaves (host array), their number
        ctypes.c_int, ctypes.c_int,  # plan: register leaves, their unit
        _P,  # stream
    ],
    "philox_draw": [
        _P, ctypes.c_int, ctypes.c_int,  # out, kind, dtype
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # ntemps rows n
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # k d word
        ctypes.c_uint, ctypes.c_uint, _P,  # row0, block, block_dev
        ctypes.c_ulonglong, _P,  # seed, the rungs' key table
        _P, ctypes.c_ulonglong,  # offset_dev, offset
        ctypes.c_int, ctypes.c_int,  # plan: threads vec
        ctypes.c_uint, ctypes.c_int,  # plan: rung_mul rung_shr
        ctypes.c_uint, ctypes.c_int,  # plan: div_mul div_shr
        _P,  # stream
    ],
}


def build_dir() -> Path:
    """``build/kernels/`` at the root of the checkout."""
    return _PKG.parent / "build" / "kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "CUDA kernels are built on first use on a machine with the "
            "CUDA toolkit"
        )
    return found


def _lib_path(name: str) -> Path:
    src = KERNELS[name][0]
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for f in (src,) + _HEADERS:
        h.update((_CSRC / f).read_bytes())
    return build_dir() / f"lib{Path(src).stem}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile every missing kernel library, one ``nvcc`` per source, all
    started together.  Returns ``{name: ptxas report}`` for the kernels
    built by this call, one name a source (empty when all were built
    already).  Raises if any build fails."""
    names = list(KERNELS) if names is None else list(names)
    first = {}  # library -> the first name that needs it
    for n in names:
        first.setdefault(_lib_path(n), n)
    todo = [n for path, n in first.items() if not path.is_file()]
    if not todo:
        return {}
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / KERNELS[n][0])]
        procs[n] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            out,
        )
    reports, failed = {}, []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n} (exit {p.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        reports[n] = log
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


@functools.cache
def library(name: str):
    """The bound C entry point of kernel ``name`` (built if missing)."""
    build_all([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    fn = getattr(lib, KERNELS[name][1])
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn
