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
    "leapfrog_masked": ("leapfrog.cu", "emcee_leapfrog_masked"),
    "pt_swap": ("pt_swap.cu", "emcee_pt_swap"),
    "philox_draw": ("philox_draw.cu", "emcee_philox_draw"),
    "kde_logpdf": ("kde_logpdf.cu", "emcee_kde_logpdf"),
    "group_order": ("shuffle_order.cu", "emcee_group_order"),
    "copy_rows": ("gather_rows.cu", "emcee_copy_rows"),
    "dime_moments": ("dime_moments.cu", "emcee_dime_moments"),
    "dime_finish": ("dime_moments.cu", "emcee_dime_finish"),
    "dime_propose": ("dime_propose.cu", "emcee_dime_propose"),
    "dez_spread": ("dez_propose.cu", "emcee_dez_spread"),
    "dez_propose": ("dez_propose.cu", "emcee_dez_propose"),
    "dez_fold": ("dez_archive.cu", "emcee_dez_fold"),
    "slice_setup": ("slice_loops.cu", "emcee_slice_setup"),
    "slice_step_out": ("slice_loops.cu", "emcee_slice_step_out"),
    "slice_shrink": ("slice_loops.cu", "emcee_slice_shrink"),
    "slice_finish": ("slice_loops.cu", "emcee_slice_finish"),
    "acf_center": ("acf.cu", "emcee_acf_center"),
    "acf_power": ("acf.cu", "emcee_acf_power"),
    "acf_reduce": ("acf.cu", "emcee_acf_reduce"),
    "tau_window": ("acf.cu", "emcee_tau_window"),
    "rank_keys": ("rhat.cu", "emcee_rank_keys"),
    "rank_scores": ("rhat.cu", "emcee_rank_scores"),
    "psrf": ("rhat.cu", "emcee_psrf"),
    "walk_propose": ("walk_propose.cu", "emcee_walk_propose"),
    "walk_subset": ("walk_propose.cu", "emcee_walk_subset"),
    "walk_keys": ("walk_propose.cu", "emcee_walk_keys"),
    "gaussian_propose": ("gaussian_propose.cu", "emcee_gaussian_propose"),
    "blend_select": ("blend_select.cu", "emcee_blend_select"),
    "chees_start": ("chees.cu", "emcee_chees_start"),
    "chees_gradient": ("chees.cu", "emcee_chees_gradient"),
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
        ctypes.c_int, ctypes.c_int,  # pair_mode, side mode
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
    "leapfrog_masked": [
        _P, _P, _P, _P,  # x_in, x_out, p_in, p_out
        _P, _P, _P,  # g, d, eps
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n nd kicks
        ctypes.c_int,  # ntemps
        _P, _P, _P,  # more, trip, done
        ctypes.c_int,  # advance
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
    "kde_logpdf": [
        _P, _P, _P, _P,  # x, c, lognorm, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n nc nd
        ctypes.c_int,  # ntemps
        *[ctypes.c_int] * 4,  # plan: rows warps tile smem
        _P,  # stream
    ],
    "group_order": [
        _P, _P, _P, _P,  # keys, order, sorted words, scratch
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # ntemps n nsplits
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # plan: chunk threads hist
        _P,  # stream
    ],
    "copy_rows": [
        _P,  # order
        _P, ctypes.c_int,  # buffer descriptors (host array), their number
        _P, ctypes.c_int,  # blocks a launch (host array), scatter
        _P,  # stream
    ],
    "dime_moments": [
        _P, _P, _P, _P,  # x, part, mean, w
        ctypes.c_int, ctypes.c_int,  # nw nd
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # skip_lo skip_n K
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # plan: rows group blocks
        ctypes.c_int, ctypes.c_int,  # ntemps, plan: threads
        ctypes.c_int,  # the block's rows staged in shared memory
        _P,  # stream
    ],
    "dime_finish": [
        _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # part nb nd K
        _P, _P, _P, _P,  # mean, cov, w, table
        ctypes.c_float, ctypes.c_float, ctypes.c_int,  # rho scale mode
        ctypes.c_int, ctypes.c_int,  # ntemps, plan: threads
        ctypes.c_int,  # the partials and the factor in shared memory
        _P,  # stream
    ],
    "dime_propose": [
        _P,  # the arguments (host struct, ops/dime_kernel.py _ProposeArgs)
        _P,  # stream
    ],
    "dez_spread": [
        _P, _P,  # x, part
        ctypes.c_int, ctypes.c_int,  # nw nd
        ctypes.c_int, ctypes.c_int,  # skip_lo skip_n
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # plan: rows group blocks
        ctypes.c_int, ctypes.c_int,  # ntemps, threads
        ctypes.c_int, ctypes.c_int,  # plan: staged, dynamic shared memory
        _P,  # stream
    ],
    "dez_propose": [
        _P,  # the arguments (host struct, ops/dez_kernel.py _ProposeArgs)
        _P,  # stream
    ],
    "dez_fold": [
        _P, _P,  # x, archive
        _P, _P, _P,  # filled, ptr, t
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nw nd capacity
        ctypes.c_int, ctypes.c_int,  # nrows stride
        ctypes.c_int, ctypes.c_int,  # ntemps, threads
        _P,  # stream
    ],
    **{name: [
        _P,  # the arguments (host struct, ops/slice_kernel.py _Args)
        _P,  # stream
    ] for name in ("slice_setup", "slice_step_out", "slice_shrink",
                   "slice_finish")},
    "acf_center": [
        _P, _P,  # x, out
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # strides
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nt lo nser
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nd m2 f64
        _P,  # stream
    ],
    "acf_power": [
        _P, ctypes.c_longlong,  # the spectrum, its complex values
        ctypes.c_int, ctypes.c_int,  # f64, blocks
        _P,  # stream
    ],
    "acf_reduce": [
        _P, _P,  # acf, part
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nt nd m2
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nw wg groups
        ctypes.c_int, ctypes.c_int,  # first, f64
        _P,  # stream
    ],
    "tau_window": [
        _P, _P, _P, _P,  # part, f, tau, win
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # groups nt nd
        ctypes.c_double, ctypes.c_int,  # nw, method
        ctypes.c_double, ctypes.c_double,  # c, floor
        _P,  # stream
    ],
    **{name: [
        _P,  # the arguments (host struct, ops/autocorr_kernel.py RhatArgs)
        _P,  # stream
    ] for name in ("rank_keys", "rank_scores", "psrf")},
    **{name: [
        _P,  # the arguments (host struct, ops/walk_kernel.py _Args)
        _P,  # stream
    ] for name in ("walk_propose", "walk_subset", "walk_keys")},
    "gaussian_propose": [
        _P,  # the arguments (host struct, ops/gaussian_kernel.py _Args)
        _P,  # stream
    ],
    "blend_select": [
        _P,  # the arguments (host struct, ops/blend_kernel.py _Args)
        _P,  # stream
    ],
    "chees_start": [
        _P, _P, _P,  # log_adj, log_T, n
        ctypes.c_float, ctypes.c_float,  # step, max_leapfrog
        ctypes.c_int,  # ntemps
        _P, _P, _P, _P,  # eps, u, T, more
        _P, _P,  # top, trip
        _P,  # stream
    ],
    "chees_gradient": [
        _P,  # the arguments (host struct, ops/chees_kernel.py _GradArgs)
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
