"""Geyer's tau, ``ess`` and ``rhat`` of the port against
``emcee_tpu.autocorr`` on the same chains.

The JAX package computes in float32 (reference defect R2); the port
keeps a numpy chain in float64 on the host and reduces a tensor on its
device.  rtol 1e-4 covers float32 rounding of the FFT, of the pair sums
over a few thousand lags, and of the rank-normalised R-hat's moments.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from emcee_tpu import autocorr as jautocorr

import emcee_tpu_torch
from emcee_tpu_torch import autocorr
from emcee_tpu_torch.ops.autocorr import _avg_ranks

RTOL = 1e-4


def ar1(n, shape, a=0.9, seed=1234):
    rng = np.random.default_rng(seed)
    x = np.empty((n,) + shape)
    x[0] = rng.normal(size=shape) / np.sqrt(1 - a * a)
    for i in range(1, n):
        x[i] = a * x[i - 1] + rng.normal(size=shape)
    return x


@pytest.mark.parametrize("shape,has_walkers", [
    ((), True), ((4,), True), ((3,), False), ((6, 3), True),
])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_geyer_tau_and_ess_match_jax(shape, has_walkers, as_tensor):
    x = ar1(20000, shape)
    arg = torch.from_numpy(x).float() if as_tensor else x
    kw = dict(has_walkers=has_walkers, method="geyer")
    got = autocorr.integrated_time(arg, **kw)
    ref = jautocorr.integrated_time(x, **kw)
    assert got.dtype == np.float64 and got.shape == np.shape(ref)
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    # AR(1) with a = 0.9 has tau = (1 + a) / (1 - a) = 19.
    assert np.all(np.abs(got - 19.0) / 19.0 < 0.25)
    e = autocorr.ess(arg, **kw)
    np.testing.assert_allclose(e, jautocorr.ess(x, **kw), rtol=RTOL)
    n_w = x.shape[1] if (x.ndim >= 2 and has_walkers) else 1
    np.testing.assert_allclose(e, x.shape[0] * n_w / got, rtol=1e-12)


def test_geyer_short_and_one_step_chains():
    x = ar1(600, (5, 2))
    got = autocorr.integrated_time(x, method="geyer", quiet=True)
    ref = jautocorr.integrated_time(x, method="geyer", quiet=True)
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    one = autocorr.integrated_time(np.ones((1, 3, 2)), method="geyer",
                                   quiet=True)
    assert one.shape == (2,) and np.isnan(one).all()
    # Sokal's ess on a tensor equals the numpy chain's.
    np.testing.assert_allclose(
        autocorr.ess(torch.from_numpy(x), quiet=True),
        autocorr.ess(x, quiet=True), rtol=1e-10)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("rank_normalized", [True, False])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_rhat_matches_jax(split, rank_normalized, as_tensor):
    x = ar1(400, (8, 3), a=0.5, seed=7)
    x[:, 0, 1] += 0.8  # a walker off the others: R-hat above 1
    x[:, :, 2] = np.round(x[:, :, 2] * 2)  # ties
    x = x.astype(np.float32)
    arg = torch.from_numpy(x) if as_tensor else x
    kw = dict(split=split, rank_normalized=rank_normalized)
    got = autocorr.rhat(arg, **kw)
    ref_host = np.asarray(jautocorr.rhat(x, **kw))
    ref_dev = np.asarray(jautocorr.rhat(jnp.asarray(x), **kw))
    assert got.dtype == np.float64 and got.shape == (3,)
    np.testing.assert_allclose(got, ref_host, rtol=RTOL)
    np.testing.assert_allclose(got, ref_dev, rtol=RTOL)
    assert got[1] > got[0]


def test_rhat_two_dimensional_input_and_errors():
    x = ar1(100, (6,), a=0.3)
    np.testing.assert_allclose(autocorr.rhat(x), jautocorr.rhat(x),
                               rtol=RTOL)
    with pytest.raises(ValueError, match="4 steps"):
        autocorr.rhat(np.zeros((3, 4, 2)))
    with pytest.raises(ValueError, match="2 chains"):
        autocorr.rhat(np.zeros((10, 1, 2)), split=False)
    with pytest.raises(ValueError):
        autocorr.rhat(np.zeros((4, 4, 2, 2)))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_collapsed_ensemble_gives_nan_rhat(as_tensor):
    """Every walker at one point: tied draws share one average rank, so
    the within-chain variance is zero and R-hat is NaN, as in JAX."""
    x = np.ones((40, 8, 2), dtype=np.float32)
    x[:, :, 1] = np.arange(40)[:, None]  # collapsed across walkers only
    arg = torch.from_numpy(x) if as_tensor else x
    got = autocorr.rhat(arg)
    ref = np.asarray(jautocorr.rhat(x))
    assert np.isnan(got[0]) and np.isnan(ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=RTOL)


def test_avg_ranks_match_scipy_rankdata():
    from scipy.stats import rankdata

    rng = np.random.default_rng(3)
    v = np.round(rng.normal(size=(500, 4)) * 3)  # many ties
    ranks, median = _avg_ranks(torch.from_numpy(v))
    np.testing.assert_array_equal(ranks.numpy(),
                                  rankdata(v, axis=0, method="average"))
    np.testing.assert_array_equal(median.numpy(), np.median(v, axis=0))


def test_public_names():
    for name in ("ess", "rhat", "integrated_time", "function_1d",
                 "AutocorrError", "next_pow_two"):
        assert name in autocorr.__all__
    assert emcee_tpu_torch.AutocorrError is autocorr.AutocorrError


@pytest.mark.parametrize("method", ["sokal", "geyer"])
def test_backends_forward_the_method(method):
    """``get_autocorr_time`` forwards its keywords: a DeviceBackend's chain
    is reduced as a tensor, the host Backend's as float64 numpy, with the
    same ``thin`` and ``discard``."""
    from emcee_tpu_torch import EnsembleSampler, moves
    from emcee_tpu_torch.backends import Backend, DeviceBackend

    got = {}
    for name, backend in (("host", Backend()), ("device", DeviceBackend())):
        s = EnsembleSampler(
            20, 2, lambda x: -0.5 * (x**2).sum(-1), vectorize=True, seed=4,
            device="cpu", backend=backend,
            moves=moves.StretchMove(randomize_split=False, pair_mode="roll"))
        s.run_mcmc(np.random.default_rng(0).normal(size=(20, 2)), 300)
        got[name] = s.get_autocorr_time(method=method, quiet=True, thin=2,
                                        discard=20)
    np.testing.assert_allclose(got["device"], got["host"], rtol=RTOL)
    chain = s.get_chain(thin=2, discard=20)
    np.testing.assert_allclose(
        got["host"], 2 * jautocorr.integrated_time(chain, method=method,
                                                   quiet=True), rtol=RTOL)
