"""The port's backends against the JAX package's Backend on the same
numpy chain, and DeviceBackend against Backend."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu.backends import Backend as JBackend

from emcee_tpu_torch import EnsembleSampler, moves
from emcee_tpu_torch.backends import Backend, DeviceBackend
from emcee_tpu_torch.convert import backend_from_numpy, state_from_numpy

K, NW, ND = 12, 10, 3


def numpy_chain(seed=0):
    rng = np.random.default_rng(seed)
    chain = rng.normal(size=(K, NW, ND)).astype(np.float32)
    log_prob = (-0.5 * (chain**2).sum(-1)).astype(np.float32)
    acc_steps = rng.uniform(size=(K, NW)) < 0.4
    return chain, log_prob, acc_steps


def jax_backend(chain, log_prob, acc_steps):
    jb = JBackend()
    jb.reset(NW, ND)
    jb.save_chunk(chain, log_prob, None, acc_steps, None)
    return jb


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("thin,discard", [(1, 0), (2, 0), (3, 2), (1, 5)])
def test_get_value_matches_jax_backend(flat, thin, discard):
    chain, log_prob, acc_steps = numpy_chain()
    jb = jax_backend(chain, log_prob, acc_steps)
    pb = backend_from_numpy(chain, log_prob, acc_steps.sum(0))
    for name in ("chain", "log_prob"):
        ref = np.asarray(jb.get_value(name, flat=flat, thin=thin,
                                      discard=discard))
        got = pb.get_value(name, flat=flat, thin=thin, discard=discard)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    assert pb.get_blobs() is None and jb.get_blobs() is None
    np.testing.assert_array_equal(pb.accepted, jb.accepted)
    assert pb.iteration == jb.iteration == K


def test_get_last_sample_matches_jax_backend():
    chain, log_prob, acc_steps = numpy_chain(1)
    jb = jax_backend(chain, log_prob, acc_steps)
    pb = backend_from_numpy(chain, log_prob, acc_steps.sum(0),
                            random_state=(5, 77))
    jl, pl = jb.get_last_sample(), pb.get_last_sample()
    np.testing.assert_array_equal(pl.coords, np.asarray(jl.coords))
    np.testing.assert_array_equal(pl.log_prob, np.asarray(jl.log_prob))
    assert pl.random_state == (5, 77)
    coords, lp, rs = pl  # legacy 3-tuple unpack
    assert rs == (5, 77) and coords.shape == (NW, ND)


def test_empty_backend_raises():
    b = Backend()
    b.reset(NW, ND)
    for get in (b.get_chain, b.get_last_sample, b.get_blobs):
        with pytest.raises(AttributeError):
            get()


def test_grow_keeps_rows_and_save_step():
    b = Backend()
    b.reset(NW, ND)
    chain, log_prob, acc_steps = numpy_chain(2)
    b.grow(2, None)
    b.save_chunk(chain[:2], log_prob[:2], None, acc_steps[:2], (1, 2))
    b.grow(5, None)
    for k in range(2, K):
        st = state_from_numpy(chain[k], log_prob[k], device="cpu")
        b.save_step(st._replace(random_state=(1, k + 1)), acc_steps[k])
    np.testing.assert_array_equal(b.get_chain(), chain)
    np.testing.assert_array_equal(b.accepted, acc_steps.sum(0))
    assert b.random_state == (1, K)
    # Blobs cannot appear in a chain stored without them (the JAX
    # package's test_grow_respects_blob_consistency).
    with pytest.raises(ValueError, match="inconsistent use of blobs"):
        b.grow(1, {"blob": np.zeros(NW)})


def test_device_backend_matches_backend_for_the_same_run():
    p0 = np.random.default_rng(3).normal(size=(NW * 2, ND))
    runs = {}
    for name, backend in (("host", Backend()), ("device", DeviceBackend())):
        s = EnsembleSampler(
            NW * 2, ND, lambda x: -0.5 * (x**2).sum(-1), vectorize=True,
            device="cpu", seed=9, backend=backend,
            moves=moves.StretchMove(randomize_split=False, pair_mode="roll"),
        )
        s.run_mcmc(p0, 30, thin_by=2)
        runs[name] = s
    host, dev = runs["host"].backend, runs["device"].backend
    assert isinstance(dev.chain, torch.Tensor)
    for kw in ({}, {"flat": True}, {"thin": 3, "discard": 4}):
        np.testing.assert_array_equal(
            dev.get_chain(**kw).astype(np.float64), host.get_chain(**kw))
        np.testing.assert_array_equal(
            dev.get_log_prob(**kw).astype(np.float64),
            host.get_log_prob(**kw))
    np.testing.assert_array_equal(dev.accepted, host.accepted)
    assert dev.random_state == host.random_state == (9, 60)
    dl, hl = dev.get_last_sample(), host.get_last_sample()
    np.testing.assert_array_equal(dl.coords.numpy(), hl.coords)
    np.testing.assert_allclose(
        dev.get_autocorr_time(quiet=True), host.get_autocorr_time(quiet=True),
        rtol=1e-4,
    )
    drained = dev.to_host()
    np.testing.assert_array_equal(drained.get_chain(), host.get_chain())
    np.testing.assert_array_equal(drained.accepted, host.accepted)
    # A second drain into the same backend adds nothing.
    assert dev.to_host(drained).iteration == host.iteration


@pytest.mark.parametrize("mode", ["chunks", "generator", "save_chunk"])
def test_device_backend_writes_every_path_like_backend(mode):
    """Kept steps written straight into DeviceBackend's rows (several
    chunks, a second run that grows the chain, the ``sample``
    generator) or copied in by ``save_chunk`` equal the host Backend's."""
    p0 = np.random.default_rng(4).normal(size=(NW * 2, ND))
    runs = {}
    for name, backend in (("host", Backend()), ("device", DeviceBackend())):
        s = EnsembleSampler(
            NW * 2, ND, lambda x: -0.5 * (x**2).sum(-1), vectorize=True,
            device="cpu", seed=5, backend=backend, max_chunk_steps=7,
        )
        if mode == "chunks":
            s.run_mcmc(p0, 16)
            s.run_mcmc(None, 9, thin_by=2)
        elif mode == "generator":
            for _ in s.sample(p0, iterations=11):
                pass
        else:
            s.run_mcmc(p0, 12)
        runs[name] = s
    host, dev = runs["host"].backend, runs["device"].backend
    if mode == "save_chunk":
        dev = DeviceBackend()
        dev.reset(NW * 2, ND)
        chain = torch.from_numpy(host.get_chain().astype(np.float32))
        lp = torch.from_numpy(host.get_log_prob().astype(np.float32))
        acc = torch.zeros(chain.shape[:2], dtype=torch.bool)
        acc[-1] = torch.from_numpy(host.accepted > 0)
        dev.save_chunk(chain[:5], lp[:5], None, acc[:5], None)
        dev.save_chunk(chain[5:], lp[5:], None, acc[5:], host.random_state)
        np.testing.assert_array_equal(dev.accepted, host.accepted > 0)
    else:
        np.testing.assert_array_equal(dev.accepted, host.accepted)
    assert dev.iteration == host.iteration
    assert dev.random_state == host.random_state
    np.testing.assert_array_equal(
        dev.get_chain().astype(np.float64), host.get_chain())
    np.testing.assert_array_equal(
        dev.get_log_prob().astype(np.float64), host.get_log_prob())
