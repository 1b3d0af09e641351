"""The port stands alone: no JAX, nothing of emcee_tpu, no silent CPU runs."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import emcee_tpu_torch
from emcee_tpu_torch import EnsembleSampler, convert
from emcee_tpu_torch.ops import accept_kernel, stretch_kernel

ROOT = Path(__file__).resolve().parent.parent
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|emcee_tpu)(?:\.|\s|$)", re.M
)


def test_import_leaves_no_jax_or_emcee_tpu():
    code = (
        "import sys\n"
        "import emcee_tpu_torch, emcee_tpu_torch.sampler, "
        "emcee_tpu_torch.convert, emcee_tpu_torch.ops._build, "
        "emcee_tpu_torch.ops.autocorr, emcee_tpu_torch.backends, "
        "emcee_tpu_torch.ops.de_kernel, emcee_tpu_torch.ops.snooker_kernel, "
        "emcee_tpu_torch.monitor, emcee_tpu_torch.utils, "
        "emcee_tpu_torch.moves.mh, emcee_tpu_torch.moves.gaussian, "
        "emcee_tpu_torch.moves.walk, emcee_tpu_torch.moves.kde, "
        "emcee_tpu_torch.checkpoint, emcee_tpu_torch.backends.hdf, "
        "emcee_tpu_torch.moves.side, emcee_tpu_torch.moves.blended, "
        "emcee_tpu_torch.moves.de_z, emcee_tpu_torch.moves.dime, "
        "emcee_tpu_torch.moves.slice, emcee_tpu_torch.chunk_graph, "
        "emcee_tpu_torch.parallel.tempering, emcee_tpu_torch.backends.pt, "
        "emcee_tpu_torch.ops.swap_kernel\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'emcee_tpu') or m.startswith(('jax.', 'jaxlib.', 'emcee_tpu.')))\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout


def test_sources_import_no_jax_or_emcee_tpu():
    files = sorted((ROOT / "emcee_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def test_forbidden_pattern_matches_what_it_should():
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from emcee_tpu.moves import StretchMove")
    assert _FORBIDDEN.search("    from emcee_tpu import State")
    assert not _FORBIDDEN.search("from emcee_tpu_torch import State")
    assert not _FORBIDDEN.search("import emcee_tpu_torch.moves")


def test_cuda_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU contract is not testable")
    with pytest.raises(RuntimeError, match="CUDA"):
        EnsembleSampler(8, 2, lambda x: -0.5 * (x**2).sum())
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.state_from_numpy(np.zeros((8, 2)))


def test_wrappers_use_the_plain_version_only_on_cpu():
    coords = torch.randn(8, 2)
    before = (stretch_kernel.stretch_propose.launches,
              accept_kernel.accept_select.launches)
    q, f = stretch_kernel.stretch_propose(
        coords, 0, 2, a=2.0, ndim_global=2, pair_mode="roll", seed=3,
        offset=4,
    )
    qp, fp = stretch_kernel.stretch_propose_plain(
        coords, 0, 2, a=2.0, ndim_global=2, pair_mode="roll", seed=3,
        offset=4,
    )
    assert torch.equal(q, qp) and torch.equal(f, fp)
    assert (stretch_kernel.stretch_propose.launches,
            accept_kernel.accept_select.launches) == before
    meta = torch.empty(8, 2, device="meta")
    with pytest.raises(ValueError, match="no K1 kernel"):
        stretch_kernel.stretch_propose(
            meta, 0, 2, a=2.0, ndim_global=2, pair_mode="roll"
        )


def test_public_names():
    assert {"EnsembleSampler", "State", "moves", "backends", "autocorr",
            "ConvergenceMonitor", "run_until_converged", "AutocorrError",
            "walkers_independent", "utils", "checkpoint",
            "__version__"} <= set(emcee_tpu_torch.__all__)
    assert {"HDFBackend", "TempHDFBackend",
            "get_test_backends"} <= set(emcee_tpu_torch.backends.__all__)
    assert {"GaussianMove", "MHMove", "WalkMove", "KDEMove", "SideMove",
            "BlendedMove", "DEZMove", "DIMEMove",
            "EnsembleSliceMove"} <= set(emcee_tpu_torch.moves.__all__)
