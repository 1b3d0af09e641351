"""Statistical end-to-end oracle for the port's stretch move.

The oracle of ``tests/integration/test_proposal.py`` (the reference's
integration harness) rewritten against ``emcee_tpu_torch`` on the CPU:
sample a unit normal, assert the acceptance-fraction window, posterior
moment bounds and a K-S test; the inverse check that a normal chain
fails a uniform K-S test.  Same tolerances as the JAX package's tests.
The JAX and torch random streams differ, so these runs are compared
with the target distribution, not with JAX chains.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from scipy import stats

import emcee_tpu_torch
from emcee_tpu_torch import moves


def normal_log_prob(params):
    return -0.5 * torch.sum(params**2)


def _test_normal(proposal, ndim=1, nwalkers=32, nsteps=2000, seed=1234,
                 **sampler_kwargs):
    coords = np.random.default_rng(seed).normal(size=(nwalkers, ndim))
    sampler = emcee_tpu_torch.EnsembleSampler(
        nwalkers, ndim, normal_log_prob, moves=proposal, seed=seed,
        device="cpu", **sampler_kwargs,
    )
    sampler.run_mcmc(coords, nsteps)

    acc = sampler.acceptance_fraction
    assert np.all((acc < 0.9) * (acc > 0.1)), f"Invalid acceptance {acc}"

    samps = sampler.get_chain(flat=True)
    mu, sig = np.mean(samps, axis=0), np.std(samps, axis=0)
    assert np.all(np.abs(mu) < 0.08), f"Incorrect mean: {mu}"
    assert np.all(np.abs(sig - 1) < 0.05), f"Incorrect standard deviation: {sig}"

    if ndim == 1:
        ks, _ = stats.kstest(samps[:, 0], "norm")
        assert ks < 0.05, "The K-S test failed"


def _test_uniform(proposal, nwalkers=32, nsteps=2000, seed=1234):
    coords = np.random.default_rng(seed).uniform(size=(nwalkers, 1))
    sampler = emcee_tpu_torch.EnsembleSampler(
        nwalkers, 1, normal_log_prob, moves=proposal, seed=seed,
        device="cpu",
    )
    sampler.run_mcmc(coords, nsteps)

    acc = sampler.acceptance_fraction
    assert np.all((acc < 0.9) * (acc > 0.1)), f"Invalid acceptance {acc}"

    samps = sampler.get_chain(flat=True)
    np.random.default_rng(seed).shuffle(samps)
    ks, _ = stats.kstest(samps[::100, 0], "uniform")
    assert ks > 0.1, "The K-S test failed"


def test_normal_stretch_roll_blocked():
    """The main path's configuration passes the oracle."""
    _test_normal(moves.StretchMove(randomize_split=False, pair_mode="roll"))


def test_normal_stretch_defaults():
    """The reference defaults: shuffled split, random partners."""
    _test_normal(moves.StretchMove())


def test_normal_stretch_weighted_mixture():
    """A weighted move list picks one move per proposal from the stream."""
    _test_normal(
        [(moves.StretchMove(randomize_split=False, pair_mode="roll"), 0.5),
         (moves.StretchMove(a=1.5), 0.5)],
        nsteps=1500,
    )
