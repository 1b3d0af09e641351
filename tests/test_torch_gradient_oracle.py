"""Statistical oracles of the port's gradient moves, as
``tests/integration/test_gradient_moves.py`` holds the JAX package's:
the moments and K-S of ``test_proposal.py``'s normal oracle, one per
move in the fast tier (shortened), the rest and the full-length runs
``slow`` (ROADMAP section 3, T1).  The streams differ from JAX's by
design (Philox), so only distributions are compared."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import emcee_tpu_torch
from emcee_tpu_torch import moves
from tests.test_torch_sampler import _test_uniform
from tests.test_torch_slice import normal_oracle

# The fast tier runs each oracle at a fraction of the JAX test's length
# (the moments of 32 walkers x 300-800 steps of a move with tau of a few
# proposals sit far inside the bounds); the slow tier at its full length.
FULL = pytest.mark.slow


@pytest.mark.parametrize("nsteps", [800, pytest.param(3000, marks=FULL)])
def test_mala_normal(nsteps):
    normal_oracle(moves.MALAMove(1.6), nsteps=nsteps)


@pytest.mark.parametrize("nsteps", [600, pytest.param(2000, marks=FULL)])
def test_hmc_normal(nsteps):
    # A good integrator on a Gaussian accepts nearly everything, so the
    # acceptance window of random-walk moves does not apply.
    normal_oracle(moves.HMCMove(0.5, n_leapfrog=5), nsteps=nsteps,
                  check_acceptance=False)


@pytest.mark.parametrize("nsteps", [400, pytest.param(3000, marks=FULL)])
def test_ensemble_mala_normal(nsteps):
    normal_oracle(moves.EnsembleMALAMove(1.2), ndim=3, nsteps=nsteps,
                  check_acceptance=False)


@pytest.mark.parametrize("nsteps", [300, pytest.param(2000, marks=FULL)])
def test_ensemble_hmc_normal(nsteps):
    normal_oracle(moves.EnsembleHMCMove(0.5, n_leapfrog=4), ndim=3,
                  nsteps=nsteps, check_acceptance=False)


@pytest.mark.slow
def test_mala_uniform_sanity():
    _test_uniform(moves.MALAMove(1.6))


@pytest.mark.slow
def test_hmc_multidim():
    normal_oracle(moves.HMCMove(0.4, n_leapfrog=8, jitter=0.3), ndim=5,
                  nsteps=2000, check_acceptance=False)


@pytest.mark.slow
@pytest.mark.parametrize("cov", [2.0, [1.0, 2.0, 0.5]])
def test_preconditioned_mala_normal(cov):
    normal_oracle(moves.MALAMove(1.0, cov=cov), ndim=3, nsteps=3000)


@pytest.mark.slow
def test_mala_tune_target():
    """Robbins-Monro drives acceptance toward the target from a far too
    large step (``test_mala_tune_target``)."""
    s = emcee_tpu_torch.EnsembleSampler(
        64, 3, lambda x: -0.5 * (x**2).sum(-1), vectorize=True, seed=0,
        device="cpu", moves=moves.MALAMove(5.0, tune_target=0.574))
    s.run_mcmc(np.random.default_rng(1).normal(size=(64, 3)), 800,
               tune=True)
    s.reset()
    s.run_mcmc(None, 500)
    assert 0.35 < float(np.mean(s.acceptance_fraction)) < 0.8


@pytest.mark.slow
def test_ensemble_hmc_affine_invariance():
    """On a strongly correlated target the ensemble mass matrix whitens
    it: acceptance > 0.6, tau < 10 and the covariance recovered
    (``test_ensemble_hmc_affine_invariance``)."""
    ndim, nwalkers, nsteps = 8, 64, 800
    rng = np.random.default_rng(5)
    A = rng.normal(size=(ndim, ndim)) / np.sqrt(ndim)
    cov = A @ A.T + 0.1 * np.eye(ndim)
    icov = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32)
    p0 = rng.normal(size=(nwalkers, ndim)) @ np.linalg.cholesky(cov).T
    s = emcee_tpu_torch.EnsembleSampler(
        nwalkers, ndim, lambda x: -0.5 * ((x @ icov) * x).sum(-1),
        vectorize=True, seed=0, device="cpu",
        moves=moves.EnsembleHMCMove(0.4, n_leapfrog=5))
    s.run_mcmc(p0, nsteps)
    assert float(np.mean(s.acceptance_fraction)) > 0.6
    assert float(np.max(s.get_autocorr_time(quiet=True, tol=0))) < 10.0
    flat = s.get_chain(flat=True, discard=nsteps // 4)
    err = np.linalg.norm(np.cov(flat, rowvar=False) - cov) / np.linalg.norm(
        cov)
    assert err < 0.15, err


@pytest.mark.slow
def test_chees_adapts_trajectory():
    """On an ill-conditioned diagonal Gaussian ChEES stretches T well
    past its short start and lands acceptance near the 0.651 target
    (``test_chees_adapts_trajectory_and_beats_fixed_l``)."""
    nd, nw = 8, 128
    sc = torch.as_tensor(np.logspace(0, 1.5, nd), dtype=torch.float32)
    s = emcee_tpu_torch.EnsembleSampler(
        nw, nd, lambda x: -0.5 * ((x / sc) ** 2).sum(-1), vectorize=True,
        seed=0, device="cpu",
        moves=moves.ChEESHMCMove(0.2, trajectory_length=0.5))
    p0 = np.random.default_rng(0).normal(size=(nw, nd)) * sc.numpy()
    s.run_mcmc(p0, 400, tune=True)
    carry = s._move_carries[0]
    assert float(carry["log_T"]) > np.log(0.5) + 1.0
    s.reset()
    s.run_mcmc(None, 300)
    assert 0.45 < float(np.mean(s.acceptance_fraction)) < 0.9
