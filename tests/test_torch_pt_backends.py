"""The port's tempered backends (``emcee_tpu_torch/backends/pt.py``)
against the JAX package's contract (``emcee_tpu/backends/pt.py``):
``PTDeviceBackend`` holds what ``PTBackend`` holds from the same seed
(the device rows in float32, the host copy in float64: equal after the
exact cast), ``to_host`` drains it, a fresh sampler resumes a stored
backend, and a JAX run's state and stored chain carry across
(``convert.pt_state_from_numpy`` / ``pt_backend_from_numpy``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu.backends.pt import PTBackend as JPTBackend
from emcee_tpu.parallel.tempering import PTSampler as JPTSampler

from emcee_tpu_torch import PTSampler
from emcee_tpu_torch.backends import PTBackend, PTDeviceBackend
from emcee_tpu_torch.convert import pt_backend_from_numpy, pt_state_from_numpy
from emcee_tpu_torch.parallel import PTState

T, NW, ND = 3, 12, 2


def ll(x):
    return -0.5 * (x**2).sum(-1)


def lp(x):
    return torch.where((x.abs() < 5.0).all(-1), 0.0, -torch.inf)


def make(backend=None, seed=2, **kw):
    return PTSampler(T, NW, ND, ll, lp, vectorize=True, seed=seed,
                     device="cpu", backend=backend, **kw)


def start(seed=0):
    return np.random.default_rng(seed).normal(size=(T, NW, ND))


def stored(s):
    return (s.get_chain(), s.get_log_like(), s.get_log_prior(),
            s.backend.accepted, s.swaps_accepted, s.swaps_proposed)


@pytest.mark.parametrize("thin_by", [1, 3])
def test_device_backend_equals_host_backend(thin_by):
    host, dev = make(), make(PTDeviceBackend(), io_chunk_bytes=2000)
    for s in (host, dev):
        s.run_mcmc(start(), 9, thin_by=thin_by)
        s.run_mcmc(None, 4, thin_by=thin_by)
    assert dev._max_chunk(True) < 13  # several chunks
    for a, b in zip(stored(host), stored(dev)):
        np.testing.assert_array_equal(np.asarray(a),
                                      np.asarray(b).astype(np.asarray(a)
                                                           .dtype))
    assert host.get_chain().dtype == np.float64
    assert dev.get_chain().dtype == np.float32
    assert host.backend.random_state == dev.backend.random_state
    np.testing.assert_array_equal(host.backend.betas, dev.backend.betas)
    last_h, last_d = host.get_last_sample(), dev.get_last_sample()
    np.testing.assert_array_equal(last_h.coords,
                                  last_d.coords.numpy().astype(np.float64))


def test_to_host_drains_incrementally():
    s = make(PTDeviceBackend())
    s.run_mcmc(start(), 5)
    host = s.backend.to_host()
    s.run_mcmc(None, 3)
    s.backend.to_host(host)
    assert host.iteration == 8
    np.testing.assert_array_equal(host.get_chain(),
                                  s.get_chain().astype(np.float64))
    np.testing.assert_array_equal(host.accepted, s.backend.accepted)
    np.testing.assert_array_equal(host.swaps_accepted, s.swaps_accepted)
    with pytest.raises(ValueError, match="ahead"):
        make(PTDeviceBackend()).backend.to_host(host)


@pytest.mark.parametrize("backend", [PTBackend, PTDeviceBackend])
def test_fresh_sampler_resumes_a_stored_backend(backend):
    a = make(backend())
    a.run_mcmc(start(), 6)
    b = make(a.backend)
    assert b.iteration == 6
    b.run_mcmc(None, 4)
    ref = make(backend())
    ref.run_mcmc(start(), 10)
    for x, y in zip(stored(ref), stored(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    with pytest.raises(ValueError, match="incompatible"):
        PTSampler(T + 1, NW, ND, ll, lp, vectorize=True, device="cpu",
                  backend=a.backend)


def test_getters_slice_like_jax_ptbackend():
    """discard, thin, flat and temp slice the stored rows as the JAX
    PTBackend does, on the same stored arrays."""
    rng = np.random.default_rng(3)
    it = 7
    chain = rng.normal(size=(it, T, NW, ND))
    lls = rng.normal(size=(it, T, NW))
    lps = rng.normal(size=(it, T, NW))
    acc = rng.integers(0, 5, size=(T, NW))
    jb = JPTBackend()
    jb.reset(T, NW, ND)
    jb.save_chunk(chain, lls, lps, acc[None], np.arange(T - 1),
                  np.arange(T - 1) + 5, jax.random.key(0),
                  np.linspace(1, 0.1, T))
    pb = pt_backend_from_numpy(chain, lls, lps, acc, np.arange(T - 1),
                               np.arange(T - 1) + 5, np.linspace(1, 0.1, T),
                               random_state=(4, 21))
    for kw in (dict(), dict(discard=2), dict(thin=2), dict(discard=1,
                                                           thin=3)):
        np.testing.assert_array_equal(pb.get_chain(**kw), jb.get_chain(**kw))
        np.testing.assert_array_equal(pb.get_log_like(**kw),
                                      jb.get_log_like(**kw))
        np.testing.assert_array_equal(pb.get_log_prior(**kw),
                                      jb.get_log_prior(**kw))
        for temp in (0, 2):
            np.testing.assert_array_equal(pb.get_chain(temp=temp, **kw),
                                          jb.get_chain(temp=temp, **kw))
            np.testing.assert_array_equal(
                pb.get_chain(temp=temp, flat=True, **kw),
                jb.get_chain(temp=temp, flat=True, **kw))
    np.testing.assert_array_equal(pb.accepted, jb.accepted)
    np.testing.assert_array_equal(pb.swaps_proposed, jb.swaps_proposed)
    last = pb.get_last_sample()
    assert isinstance(last, PTState) and last.random_state == (4, 21)
    np.testing.assert_array_equal(last.coords, chain[-1])
    assert pb.shape == (T, NW, ND) and not pb.has_blobs
    empty = PTBackend()
    empty.reset(T, NW, ND)
    with pytest.raises(AttributeError):
        empty.get_chain()


def test_jax_state_continues_in_the_port():
    """A JAX PTState's arrays start the port's sampler, which goes on
    from them: every stored logL is the function at its stored coords."""
    jpt = JPTSampler(T, NW, ND, lambda x: -0.5 * jnp.sum(x**2),
                     lambda x: jnp.where(jnp.all(jnp.abs(x) < 5.0), 0.0,
                                         -jnp.inf), seed=1)
    jst = jpt.run_mcmc(start(4), 5)
    st = pt_state_from_numpy(np.asarray(jst.coords),
                             np.asarray(jst.log_like),
                             np.asarray(jst.log_prior), seed=8,
                             device="cpu")
    assert st.random_state == (8, 0)
    s = make()
    s.run_mcmc(st, 3)
    assert s.iteration == 3
    # Every stored logL equals the function at its stored coords.
    c = torch.tensor(s.get_chain()[-1], dtype=torch.float32)
    np.testing.assert_allclose(s.get_log_like()[-1], ll(c).numpy(),
                               rtol=1e-6)


def test_blobs_and_the_hdf_backend_are_refused(tmp_path):
    """Blobs were refused until P11b ported them: both backends now store
    a chunk's blobs and give them back, and ``PTHDFBackend`` opens."""
    from emcee_tpu_torch.backends import PTHDFBackend

    b = PTBackend()
    b.reset(T, NW, ND)
    b.grow(3, blobs=np.zeros((T, NW)))
    assert b.blobs.shape == (3, T, NW)
    d = PTDeviceBackend()
    d.reset(T, NW, ND)
    d.save_chunk(np.zeros((1, T, NW, ND)), np.zeros((1, T, NW)),
                 np.zeros((1, T, NW)), np.zeros((1, T, NW), bool),
                 [0, 0], [0, 0], (0, 1), [1, 0.5, 0.2],
                 blobs=np.ones((1, T, NW)))
    np.testing.assert_array_equal(d.get_blobs(), np.ones((1, T, NW)))
    h = PTHDFBackend(str(tmp_path / "pt.h5"))
    assert not h.initialized
