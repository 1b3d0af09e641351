"""``PTHDFBackend``, ``io_dtype``, ``parameter_names`` and the monitor on
the port's PTSampler, against the JAX package's.

A file written by the JAX package's ``PTHDFBackend`` reads in the port's
and the reverse, blobs included (the same group schema; each package
reads its own random-state attr only).  Then the twins of
``tests/unit/test_pt_backends.py:37-184`` (the HDF store equals the
memory store, a fresh sampler resumes the file as an uninterrupted run
goes on, the last sample round-trips, a device store drains into it, the
blob field names are checked, the blob record dataset), of
``tests/unit/test_pt_parity.py:134`` and ``:285`` (named parameters;
blobs into the HDF store), ``tests/unit/test_tempering.py:320``
(``io_dtype`` compresses the stored chain only) and of the JAX monitor
on a tempered sampler (``emcee_tpu/monitor.py:101-118``: judged on the
cold rung).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

pytest.importorskip("h5py")

from emcee_tpu import autocorr as jautocorr
from emcee_tpu.backends.pt import PTHDFBackend as JPTHDFBackend
from emcee_tpu.parallel.tempering import PTSampler as JPTSampler

from emcee_tpu_torch import ConvergenceMonitor, PTSampler, run_until_converged
from emcee_tpu_torch.backends import PTBackend, PTDeviceBackend, PTHDFBackend

T, NW, ND = 3, 16, 2


def ll(x):
    return -0.5 * torch.sum(x**2)


def ll_blobs(x):
    v = -0.5 * torch.sum(x**2)
    return v, 2.0 * v, x


def lp(x):
    return torch.where(torch.all(torch.abs(x) < 10.0), 0.0, -torch.inf)


def j_ll_blobs(x):
    v = -0.5 * jnp.sum(x**2)
    return v, 2.0 * v, x


def j_lp(x):
    return jnp.where(jnp.all(jnp.abs(x) < 10.0), 0.0, -jnp.inf)


def p0(seed=7):
    return np.random.default_rng(seed).normal(size=(T, NW, ND))


def run(backend, n=20, like=ll, seed=0, **kw):
    s = PTSampler(T, NW, ND, like, lp, seed=seed, backend=backend,
                  device="cpu", **kw)
    s.run_mcmc(p0(), n)
    return s


@pytest.fixture
def h5file(tmp_path):
    return str(tmp_path / "pt.h5")


def test_hdf_matches_memory(h5file):
    m = run(PTBackend(), like=ll_blobs)
    h = run(PTHDFBackend(h5file), like=ll_blobs)
    for get in ("get_chain", "get_log_like", "get_log_prior"):
        np.testing.assert_array_equal(getattr(m, get)(), getattr(h, get)())
    for a, b in zip(m.get_blobs(), h.get_blobs()):
        np.testing.assert_array_equal(a, b)
    for name in ("accepted", "swaps_accepted", "swaps_proposed"):
        np.testing.assert_array_equal(getattr(m, name), getattr(h, name))
    np.testing.assert_array_equal(m.backend.betas, h.backend.betas)
    assert h.backend.random_state == m.backend.random_state


def test_hdf_resume_matches_uninterrupted(h5file):
    full = run(PTBackend(), n=30)
    run(PTHDFBackend(h5file), n=18)
    again = PTSampler(T, NW, ND, ll, lp, seed=0,
                      backend=PTHDFBackend(h5file), device="cpu")
    assert again.iteration == 18
    again.run_mcmc(None, 12)
    np.testing.assert_array_equal(again.get_chain(), full.get_chain())
    np.testing.assert_array_equal(again.swaps_proposed, full.swaps_proposed)


def test_last_sample_roundtrip_and_device_drain(h5file):
    d = run(PTDeviceBackend(), like=ll_blobs)
    h = d.backend.to_host(PTHDFBackend(h5file))
    last = h.get_last_sample()
    np.testing.assert_array_equal(last.coords, d.get_chain()[-1])
    np.testing.assert_array_equal(last.blobs[1], d.get_blobs()[1][-1])
    assert last.random_state == d.backend.random_state
    np.testing.assert_array_equal(h.accepted, d.backend.accepted)


def test_blob_record_dataset_and_field_names(h5file):
    """The twins of test_pt_parity.py:285 and test_pt_backends.py:184."""
    s = run(PTHDFBackend(h5file), n=15, like=ll_blobs)
    b0, b1 = s.get_blobs()
    assert b0.shape == (15, T, NW)
    np.testing.assert_array_equal(b0, 2.0 * s.get_log_like())
    np.testing.assert_array_equal(b1, s.get_chain())
    rec = s.backend.get_blobs(structured=True)
    assert rec.shape == (15, T, NW)
    assert set(rec.dtype.names) == {"blob0", "blob1"}
    t0, _ = s.backend.get_blobs(temp=0)
    np.testing.assert_array_equal(t0, b0[:, 0])
    again = PTSampler(T, NW, ND, ll_blobs, lp, seed=0,
                      backend=PTHDFBackend(h5file), device="cpu")
    again.run_mcmc(None, 5)
    assert again.get_blobs()[0].shape == (20, T, NW)
    b = PTHDFBackend(h5file, name="named")
    b.reset(2, 4, 3)
    ok = {k: np.zeros((3, 2, 4), np.float32) for k in ("a", "b")}
    b.save_chunk(np.zeros((3, 2, 4, 3)), np.zeros((3, 2, 4)),
                 np.zeros((3, 2, 4)), np.zeros((3, 2, 4)), [0], [0], None,
                 [1.0, 0.5], blobs=ok)
    bad = {k: np.zeros((2, 2, 4), np.float32) for k in ("b", "c")}
    with pytest.raises(ValueError, match="field names changed"):
        b.save_chunk(np.zeros((2, 2, 4, 3)), np.zeros((2, 2, 4)),
                     np.zeros((2, 2, 4)), np.zeros((2, 2, 4)), [0], [0],
                     None, [1.0, 0.5], blobs=bad)


def test_a_jax_file_reads_in_the_port(h5file):
    j = JPTSampler(T, NW, ND, j_ll_blobs, j_lp, seed=0,
                   backend=JPTHDFBackend(h5file))
    j.run_mcmc(p0(), 12)
    b = PTHDFBackend(h5file)
    np.testing.assert_array_equal(b.get_chain(), np.asarray(j.get_chain()))
    for a, c in zip(b.get_blobs(), j.get_blobs()):
        np.testing.assert_array_equal(a, np.asarray(c))
    np.testing.assert_array_equal(b.betas, j.betas)
    assert b.random_state is None  # the JAX package's key is not the port's
    s = PTSampler(T, NW, ND, ll_blobs, lp, seed=4, backend=b, device="cpu")
    s.run_mcmc(None, 6)
    assert s.iteration == 18 and s.get_blobs()[1].shape == (18, T, NW, ND)
    np.testing.assert_array_equal(s.get_blobs()[1][12:], s.get_chain()[12:])


def test_a_port_file_reads_in_the_jax_package(h5file):
    s = run(PTHDFBackend(h5file), n=12, like=ll_blobs)
    j = JPTHDFBackend(h5file)
    np.testing.assert_array_equal(j.get_chain(), s.get_chain())
    np.testing.assert_array_equal(j.get_log_like(), s.get_log_like())
    for a, c in zip(j.get_blobs(), s.get_blobs()):
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(j.swaps_proposed, s.swaps_proposed)
    assert j.random_state is None
    jpt = JPTSampler(T, NW, ND, j_ll_blobs, j_lp, seed=1, backend=j)
    jpt.run_mcmc(None, 3)
    assert jpt.iteration == 15


def test_pt_io_dtype():
    """The twin of test_tempering.py:320: ``io_dtype`` rounds only the
    stored chain; the trajectory is the full-precision run's."""

    def make(io_dtype, backend):
        s = PTSampler(4, 16, 2, ll, lp, seed=9, backend=backend,
                      io_dtype=io_dtype, device="cpu")
        s.run_mcmc(np.random.default_rng(4).normal(size=(4, 16, 2)), 30)
        return s

    p16 = make(np.float16, PTBackend(dtype=np.float16))
    p32 = make(None, PTBackend())
    assert p16.backend.chain.dtype == np.float16
    np.testing.assert_array_equal(
        p16.get_chain(), p32.get_chain().astype(np.float16))
    np.testing.assert_array_equal(p16._previous_state.coords,
                                  p32._previous_state.coords)
    assert np.all(np.isfinite(p16.get_log_like()))
    d16 = make(np.float16, PTDeviceBackend())
    assert d16.backend.chain.dtype == torch.float16
    np.testing.assert_array_equal(d16.get_chain(), p16.get_chain())


def test_pt_parameter_names():
    """The twin of test_pt_parity.py:134."""

    def named_like(p):
        return -0.5 * (p["a"] ** 2 + torch.sum(p["b"] ** 2))

    def named_prior(p):
        return torch.where(torch.abs(p["a"]) < 20.0, 0.0, -torch.inf)

    s = PTSampler(3, 8, 3, named_like, named_prior,
                  parameter_names={"a": 0, "b": [1, 2]}, seed=0,
                  device="cpu")
    s.run_mcmc(np.random.default_rng(1).normal(size=(3, 8, 3)), 10)
    np.testing.assert_allclose(s.get_log_like(),
                               -0.5 * np.sum(s.get_chain()**2, axis=-1),
                               rtol=1e-5)
    with pytest.raises(AssertionError):
        PTSampler(3, 8, 3, named_like, named_prior, parameter_names=["a"],
                  device="cpu")


@pytest.mark.parametrize("backend", [PTBackend, PTDeviceBackend])
def test_run_until_converged_judges_the_cold_rung(backend):
    s = PTSampler(T, NW, ND, ll, lp, seed=2, backend=backend(),
                  device="cpu")
    _, mon = run_until_converged(
        s, p0(), max_steps=600, check_every=200,
        monitor=ConvergenceMonitor(tau_factor=10, dtau_rel=0.5))
    assert s.iteration in (200, 400, 600)
    want = jautocorr.integrated_time(s.get_chain(temp=0), quiet=True)
    np.testing.assert_allclose(mon.tau, np.asarray(want), rtol=1e-6)
