"""The port's autocorrelation estimator against ``emcee_tpu.autocorr``.

The JAX package estimates in float32 (reference defect R2); the port
keeps the estimate in float64 on the host.  So the two agree to float32
tolerance: rtol 1e-4 covers float32 rounding accumulated by the FFT and
by the cumulative sum over a few thousand lags.
"""

import logging

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu import autocorr as jautocorr

from emcee_tpu_torch import autocorr

RTOL = 1e-4


def ar1(n, shape, a=0.9, seed=1234):
    rng = np.random.default_rng(seed)
    x = np.empty((n,) + shape)
    x[0] = 0.0
    for i in range(1, n):
        x[i] = a * x[i - 1] + rng.normal(size=shape)
    return x


def test_function_1d_matches_jax():
    x = ar1(3000, ())
    got = autocorr.function_1d(x)
    ref = jautocorr.function_1d(x)
    assert got.shape == ref.shape == (3000,)
    assert got[0] == 1.0
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-5)
    with pytest.raises(ValueError):
        autocorr.function_1d(np.zeros((4, 4)))


@pytest.mark.parametrize("shape,has_walkers", [
    ((), True), ((4,), True), ((3,), False), ((6, 3), True),
])
def test_integrated_time_matches_jax(shape, has_walkers):
    x = ar1(20000, shape)
    got = autocorr.integrated_time(x, has_walkers=has_walkers)
    ref = jautocorr.integrated_time(x, has_walkers=has_walkers)
    assert got.dtype == np.float64
    assert got.shape == np.shape(ref)
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    # AR(1) with a = 0.9 has tau = (1 + a) / (1 - a) = 19.
    assert np.all(np.abs(got - 19.0) / 19.0 < 0.25)


def test_tensor_input_matches_numpy_input():
    x = ar1(4000, (5, 2))
    a = autocorr.integrated_time(x)
    b = autocorr.integrated_time(torch.from_numpy(x).float())
    np.testing.assert_allclose(a, b, rtol=RTOL)


def test_short_chain_raises_or_warns(caplog):
    x = ar1(300, (4, 2))
    with pytest.raises(autocorr.AutocorrError) as err:
        autocorr.integrated_time(x)
    with pytest.raises(jautocorr.AutocorrError) as jerr:
        jautocorr.integrated_time(x)
    np.testing.assert_allclose(err.value.tau, jerr.value.tau, rtol=RTOL)
    with caplog.at_level(logging.WARNING):
        tau = autocorr.integrated_time(x, quiet=True)
    assert "shorter than" in caplog.text
    np.testing.assert_allclose(tau, err.value.tau)
    with pytest.raises(NotImplementedError, match="P5"):
        autocorr.integrated_time(x, method="geyer")
    with pytest.raises(ValueError):
        autocorr.integrated_time(np.zeros((2, 2, 2, 2)))
