"""The port's ``HDFBackend`` against the JAX package's, at the file level.

A file the port writes reads through ``emcee_tpu.backends.HDFBackend``
with equal chain, log-prob, blobs, accepted counts, iteration and attrs
(the schema of ``emcee_tpu/backends/hdf.py``); a file the JAX package
writes reads in the port and a port sampler resumes it (its stream then
starts from the sampler's seed: the file has no ``torch_random_state``).
The values are compared exactly: both packages store the same float32
rows in float64 datasets.  Then the errors of
``tests/unit/test_blobs.py:95-151`` and ``tests/unit/test_backends.py``
that involve a file, and the backend's own surface.
"""

import subprocess
import sys
from pathlib import Path

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import emcee_tpu
from emcee_tpu.backends import HDFBackend as JHDFBackend

import emcee_tpu_torch
from emcee_tpu_torch import backends
from emcee_tpu_torch.backends import HDFBackend, TempHDFBackend

ROOT = Path(__file__).resolve().parent.parent
NW, ND = 16, 3


def lp_torch(x):
    return (-0.5 * (x**2).sum(-1), x.sum(-1),
            {"pos": (x > 0).sum(-1).int(), "v": 2 * x})


def lp_jax(x):
    return (-0.5 * jnp.sum(x**2, axis=-1), jnp.sum(x, axis=-1),
            {"pos": jnp.sum(x > 0, axis=-1).astype(jnp.int32), "v": 2 * x})


def p0(seed=0):
    return np.random.default_rng(seed).normal(size=(NW, ND))


def attrs(path, name):
    with h5py.File(path, "r") as f:
        return {k: (np.asarray(v).tolist() if isinstance(v, np.ndarray)
                    else v) for k, v in f[name].attrs.items()}


@pytest.mark.parametrize("declared", [None, [("s", float), ("pos", int),
                                             ("v", float)]])
def test_port_file_reads_in_the_jax_package(tmp_path, declared):
    path = str(tmp_path / "port.h5")
    s = emcee_tpu_torch.EnsembleSampler(
        NW, ND, lp_torch, vectorize=True, seed=3, device="cpu",
        backend=HDFBackend(path), blobs_dtype=declared)
    s.run_mcmc(p0(), 6)
    s.run_mcmc(None, 4)
    j = JHDFBackend(path, read_only=True)
    p = HDFBackend(path, read_only=True)
    assert j.iteration == p.iteration == 10
    assert j.shape == p.shape == (NW, ND)
    for name in ("chain", "log_prob", "blobs"):
        got, want = p.get_value(name), j.get_value(name)
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(j.accepted, p.accepted)
    np.testing.assert_array_equal(p.accepted, s.backend.accepted)
    a = attrs(path, "mcmc")
    assert a["has_blobs"] and a["iteration"] == 10
    assert a["blobs_kind"] == "other"
    want_fields = ["s", "pos", "v"] if declared else ["blob0", "blob1",
                                                     "blob2"]
    assert a["blobs_fields"] == want_fields
    assert "jax_random_state" not in a
    assert a["torch_random_state"] == [3, 10]
    assert p.random_state == (3, 10) and j.random_state is None
    # A JAX sampler reads the port's chain back as its own.
    js = emcee_tpu.EnsembleSampler(NW, ND, lp_jax, vectorize=True, seed=1,
                                   backend=JHDFBackend(path, read_only=True),
                                   blobs_dtype=declared)
    np.testing.assert_array_equal(js.get_chain(), s.get_chain())
    np.testing.assert_array_equal(js.get_log_prob(), s.get_log_prob())
    got, want = s.get_blobs(), js.get_blobs()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("blob", ["leaf", "dict"])
def test_jax_file_reads_and_resumes_in_the_port(tmp_path, blob):
    path = str(tmp_path / "jax.h5")

    def jfn(x):
        lp = -0.5 * jnp.sum(x**2)
        return (lp, lp) if blob == "leaf" else (
            lp, {"a": jnp.sum(x), "b": x})

    def tfn(x):
        lp = -0.5 * (x**2).sum()
        return (lp, lp) if blob == "leaf" else (lp, {"a": x.sum(), "b": x})

    js = emcee_tpu.EnsembleSampler(NW, ND, jfn, seed=5,
                                   backend=JHDFBackend(path))
    js.run_mcmc(p0(1), 5)
    jchain = js.get_chain()
    p = HDFBackend(path)
    for name in ("chain", "log_prob", "blobs"):
        got, want = p.get_value(name), js.backend.get_value(name)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert p.random_state is None
    last = p.get_last_sample()
    np.testing.assert_array_equal(last.coords, jchain[-1])
    # The port resumes the file; with no Philox state in it, its stream
    # starts from its own seed at offset 0.
    s = emcee_tpu_torch.EnsembleSampler(NW, ND, tfn, seed=8, device="cpu",
                                        backend=p)
    assert s.iteration == 5
    st = s.run_mcmc(None, 4)
    assert st.random_state == (8, 4)
    assert s.iteration == 9 and p.random_state == (8, 4)
    chain = p.get_chain()
    np.testing.assert_array_equal(chain[:5], jchain)
    assert np.isfinite(chain).all()
    blobs = s.get_blobs()
    if blob == "leaf":
        np.testing.assert_array_equal(blobs, s.get_log_prob())
    else:
        np.testing.assert_array_equal(blobs["b"], chain)


def test_hdf_dict_blob_key_change_rejected(tmp_path):
    b = HDFBackend(str(tmp_path / "blobs.h5"))
    b.reset(4, 2)
    coords = np.zeros((3, 4, 2))
    lp = np.zeros((3, 4))
    acc = np.zeros((3, 4), np.int32)
    ok = {"a": np.zeros((3, 4), np.float32), "b": np.ones((3, 4), np.float32)}
    b.save_chunk(coords, lp, ok, acc, None)
    bad = {"b": np.zeros((2, 4), np.float32), "c": np.ones((2, 4), np.float32)}
    with pytest.raises(ValueError, match="field names changed"):
        b.save_chunk(coords[:2], lp[:2], bad, acc[:2], None)


def test_hdf_blob_kind_change_rejected(tmp_path):
    b = HDFBackend(str(tmp_path / "kind.h5"))
    b.reset(4, 2)
    coords = np.zeros((2, 4, 2))
    lp = np.zeros((2, 4))
    acc = np.zeros((2, 4), np.int32)
    ok = {"zz": np.zeros((2, 4), np.float32), "aa": np.ones((2, 4), np.float32)}
    b.save_chunk(coords, lp, ok, acc, None)
    bad = (np.zeros((2, 4), np.float32), np.ones((2, 4), np.float32))
    with pytest.raises(ValueError, match="kind"):
        b.save_chunk(coords, lp, bad, acc, None)


def test_hdf_inconsistent_blob_use_rejected(tmp_path):
    coords = np.zeros((2, 4, 2))
    lp = np.zeros((2, 4))
    acc = np.zeros((2, 4), np.int32)
    b = HDFBackend(str(tmp_path / "incons.h5"))
    b.reset(4, 2)
    b.save_chunk(coords, lp, np.ones((2, 4), np.float32), acc, None)
    with pytest.raises(ValueError, match="inconsistent use of blobs"):
        b.save_chunk(coords, lp, None, acc, None)
    b2 = HDFBackend(str(tmp_path / "incons2.h5"))
    b2.reset(4, 2)
    b2.save_chunk(coords, lp, None, acc, None)
    with pytest.raises(ValueError, match="inconsistent use of blobs"):
        b2.save_chunk(coords, lp, np.ones((2, 4), np.float32), acc, None)
    with pytest.raises(ValueError, match="inconsistent use of blobs"):
        b2.grow(5, np.zeros((4,), np.float32))


@pytest.mark.parametrize("first_blobs", [True, False])
def test_hdf_blob_change_between_samplers_rejected(tmp_path, first_blobs):
    """``test_blobs.py:113-133`` and ``test_backends.py:330-347``."""
    path = str(tmp_path / "stale.h5")

    def with_blobs(x):
        return -0.5 * (x**2).sum(), x.sum()

    def without(x):
        return -0.5 * (x**2).sum()

    fns = (with_blobs, without) if first_blobs else (without, with_blobs)
    s1 = emcee_tpu_torch.EnsembleSampler(8, 2, fns[0], seed=0, device="cpu",
                                         backend=HDFBackend(path))
    s1.run_mcmc(np.random.default_rng(1).normal(size=(8, 2)), 4)
    s2 = emcee_tpu_torch.EnsembleSampler(8, 2, fns[1], seed=0, device="cpu",
                                         backend=HDFBackend(path))
    with pytest.raises(ValueError, match="inconsistent use of blobs"):
        s2.run_mcmc(None, 3)


def test_read_only_and_not_ported_options(tmp_path):
    path = str(tmp_path / "ro.h5")
    b = HDFBackend(path)
    b.reset(4, 2)
    ro = HDFBackend(path, read_only=True)
    with pytest.raises(RuntimeError, match="read-only"):
        ro.reset(4, 2)
    with pytest.raises(NotImplementedError, match="P13"):
        HDFBackend(path, shard_per_process=True)
    assert not HDFBackend(str(tmp_path / "missing.h5")).initialized
    with pytest.raises(AttributeError):
        b.get_last_sample()


def test_temp_backend_dtype_and_test_backends():
    assert backends.get_test_backends() == [
        backends.Backend, backends.DeviceBackend, TempHDFBackend]
    with TempHDFBackend(dtype=np.float32, compression="gzip") as hdf:
        s = emcee_tpu_torch.EnsembleSampler(
            NW, ND, lambda x: -0.5 * (x**2).sum(-1), vectorize=True,
            device="cpu", backend=hdf)
        s.run_mcmc(p0(2), 5)
        assert s.get_chain().dtype == np.float32
        assert s.get_chain().shape == (5, NW, ND)
        assert s.get_blobs() is None
        assert s.get_autocorr_time(quiet=True).shape == (ND,)
        path = hdf.filename
    assert not Path(path).exists()
    assert isinstance(backends.hdf.does_hdf5_support_longdouble(), bool)
    from emcee_tpu.backends.hdf import (
        does_hdf5_support_longdouble as j_longdouble)
    assert (backends.hdf.does_hdf5_support_longdouble()
            == j_longdouble())


def test_h5py_is_needed_only_to_make_a_backend():
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "import emcee_tpu_torch\n"
        "from emcee_tpu_torch.backends import HDFBackend, get_test_backends\n"
        "assert len(get_test_backends()) == 2\n"
        "try:\n"
        "    HDFBackend('x.h5')\n"
        "except ImportError as e:\n"
        "    print('ImportError', e)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.startswith("ImportError you must install 'h5py'")
