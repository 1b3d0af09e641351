"""Weighted move mixtures and ``mixture_block`` in the port, against the
JAX package.

* ``chunk_schedule`` equals ``emcee_tpu.driver.chunk_schedule`` on a grid;
* the sampler's validation and fallback rules are those of
  ``tests/integration/test_mixture.py:92-121,144-168``;
* within a block exactly one move runs, seen through the kernels'
  wrappers on the plain path;
* workload 3 at a small size (64 walkers, 8-D correlated Gaussian, the
  DE 0.8 + snooker 0.2 roll mixture of ``benchmarks/workload3.py``) runs
  through both packages, and each one's sample covariance matches the
  target's within a Monte-Carlo tolerance stated from the chain's own
  autocorrelation time.
The slow oracle runs are in ``test_torch_mixture_oracle.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import emcee_tpu
from emcee_tpu.driver import chunk_schedule as j_chunk_schedule

import emcee_tpu_torch
from emcee_tpu_torch import moves
from emcee_tpu_torch.autocorr import integrated_time
from emcee_tpu_torch.driver import choose_move, chunk_schedule
from emcee_tpu_torch.ops import de_kernel, snooker_kernel


def lp_gauss(x):
    return -0.5 * (x**2).sum(-1)


def mixture(jax_moves=False):
    mv = emcee_tpu.moves if jax_moves else moves
    return [
        (mv.DEMove(pair_mode="roll", randomize_split=False), 0.8),
        (mv.DESnookerMove(pair_mode="roll", nsplits=2,
                          randomize_split=False), 0.2),
    ]


@pytest.mark.parametrize("blk", [1, 2, 3, 4, 7, 32])
def test_chunk_schedule_matches_jax(blk):
    for nsteps in (1, 2, 5, 7, 10, 31, 32, 64, 100, 129, 1000, 4097):
        for max_chunk in (1, 3, 8, 25, 100, 4096):
            assert chunk_schedule(nsteps, max_chunk, blk) == \
                j_chunk_schedule(nsteps, max_chunk, blk), (nsteps, max_chunk)


def test_sampler_chunk_schedule():
    """The values of ``test_mixture.py:144-157``."""
    s = emcee_tpu_torch.EnsembleSampler(
        32, 2, lp_gauss, vectorize=True, moves=mixture(), mixture_block=32,
        seed=0, device="cpu")
    assert s._chunk_schedule(100, 25) == [32, 32, 32, 4]
    assert s._chunk_schedule(64, 100) == [64]
    assert s._chunk_schedule(10, 100) == [10]
    s1 = emcee_tpu_torch.EnsembleSampler(
        32, 2, lp_gauss, vectorize=True, mixture_block=32, seed=0,
        device="cpu")
    assert s1._chunk_schedule(100, 25) == [25, 25, 25, 25]


def test_mixture_block_validation_and_fallback():
    with pytest.raises(ValueError, match="mixture_block"):
        emcee_tpu_torch.EnsembleSampler(8, 2, lp_gauss, mixture_block=0,
                                        device="cpu")
    # nkeep not a block multiple -> per-proposal fallback still runs.
    s = emcee_tpu_torch.EnsembleSampler(
        32, 2, lp_gauss, vectorize=True,
        moves=[(moves.DEMove(), 0.5), (moves.StretchMove(), 0.5)],
        mixture_block=7, seed=0, device="cpu")
    s.run_mcmc(np.random.default_rng(0).normal(size=(32, 2)), 10)
    assert s.get_chain().shape == (10, 32, 2)
    # io-limited chunks with a ragged tail store the full chain.
    s2 = emcee_tpu_torch.EnsembleSampler(
        32, 2, lp_gauss, vectorize=True, moves=mixture(), mixture_block=8,
        max_chunk_steps=6, seed=0, device="cpu")
    assert s2._chunk_schedule(20, 6) == [8, 8, 4]
    s2.run_mcmc(np.random.default_rng(0).normal(size=(32, 2)), 20)
    chain = s2.get_chain()
    assert chain.shape == (20, 32, 2) and np.isfinite(chain).all()


def counting(monkeypatch):
    """Route both proposal wrappers through a recorder; returns the list
    of kernel names in call order."""
    calls = []
    for mod, name in ((de_kernel, "de_propose"),
                      (snooker_kernel, "snooker_propose")):
        fn = getattr(mod, name)

        def rec(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, rec)
    return calls


@pytest.mark.parametrize("thin_by", [1, 3])
def test_one_move_per_block(monkeypatch, thin_by):
    """With mixture_block=4, every run of 4 kept steps calls one kernel
    only, the one its block's draw names; the ragged tail chunk (2 kept
    steps) draws per proposal."""
    calls = counting(monkeypatch)
    nw, blk, nsteps = 16, 4, 42
    s = emcee_tpu_torch.EnsembleSampler(
        nw, 2, lp_gauss, vectorize=True,
        moves=[(m, 0.5) for m, _ in mixture()], mixture_block=blk, seed=3,
        device="cpu")
    s.run_mcmc(np.random.default_rng(1).normal(size=(nw, 2)), nsteps,
               thin_by=thin_by, store=False)
    per_prop = 2  # both moves run two splits per proposal
    per_block = blk * thin_by * per_prop
    nblocks = (nsteps // blk)
    assert len(calls) == nsteps * thin_by * per_prop
    names = ("de_propose", "snooker_propose")
    seen = set()
    for b in range(nblocks):
        block = calls[b * per_block:(b + 1) * per_block]
        assert len(set(block)) == 1, block
        want = choose_move(s._weights, 3, b * blk * thin_by, block=True)
        assert block[0] == names[want]
        seen.add(block[0])
    assert seen == set(names)
    tail = calls[nblocks * per_block:]
    offset0 = nblocks * blk * thin_by
    assert tail == [names[choose_move(s._weights, 3, offset0 + p)]
                    for p in range(len(tail) // per_prop)
                    for _ in range(per_prop)]


def test_per_proposal_choice_without_blocks(monkeypatch):
    calls = counting(monkeypatch)
    s = emcee_tpu_torch.EnsembleSampler(
        16, 2, lp_gauss, vectorize=True,
        moves=[(m, 0.5) for m, _ in mixture()], seed=4, device="cpu")
    s.run_mcmc(np.random.default_rng(1).normal(size=(16, 2)), 40,
               store=False)
    names = ("de_propose", "snooker_propose")
    assert calls[::2] == [names[choose_move(s._weights, 4, p)]
                          for p in range(40)]
    assert calls[::2] == calls[1::2]


def workload3_target(nd):
    """``benchmarks/workload3.py:57-69`` at ``nd`` dimensions: one numpy
    ``W = chol(inv(cov))`` for both packages."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(nd, nd)) / np.sqrt(nd)
    cov = a @ a.T + 0.5 * np.eye(nd)
    w = np.linalg.cholesky(np.linalg.inv(cov)).astype(np.float32)
    p0 = rng.normal(size=(64, nd)) @ np.linalg.cholesky(cov).T
    return cov, w, p0


def covariance_error(chain, w, discard):
    """Max |whitened sample covariance - I| over a chain, and the
    Monte-Carlo tolerance: 5 standard errors of a unit variance, sqrt(2
    tau / N) with tau the largest integrated time (Sokal) of the whitened
    chain."""
    y = chain[discard:] @ w
    flat = y.reshape(-1, y.shape[-1])
    c = np.cov(flat, rowvar=False)
    tau = float(np.max(integrated_time(y, quiet=True)))
    tol = 5.0 * np.sqrt(2.0 * tau / flat.shape[0])
    return float(np.abs(c - np.eye(c.shape[0])).max()), tol, tau


@pytest.mark.parametrize("blk", [1, 4])
def test_small_workload3_in_both_packages(blk):
    nd, nw, nsteps, discard = 8, 64, 2000, 200
    cov, w, p0 = workload3_target(nd)
    wj = jnp.asarray(w)

    js = emcee_tpu.EnsembleSampler(
        nw, nd, lambda x: -0.5 * jnp.sum((x @ wj) ** 2, axis=-1),
        vectorize=True, moves=mixture(jax_moves=True), mixture_block=blk,
        seed=0)
    js.run_mcmc(emcee_tpu.State(jnp.asarray(p0, jnp.float32),
                                random_state=jax.random.key(2)), nsteps)
    wt = torch.from_numpy(w)
    ts = emcee_tpu_torch.EnsembleSampler(
        nw, nd, lambda x: -0.5 * ((x @ wt) ** 2).sum(-1), vectorize=True,
        moves=mixture(), mixture_block=blk, seed=2, device="cpu")
    ts.run_mcmc(p0, nsteps)
    accs = []
    for label, chain, acc in (
            ("jax", np.asarray(js.get_chain()), js.acceptance_fraction),
            ("torch", ts.get_chain(), ts.acceptance_fraction)):
        assert chain.shape == (nsteps, nw, nd) and np.isfinite(chain).all()
        err, tol, tau = covariance_error(chain, w, discard)
        assert err < tol, f"{label}: covariance off by {err} > {tol} (tau {tau})"
        accs.append(float(np.mean(acc)))
    # The same mixture accepts at the same rate in both packages (0.28
    # here; its Monte-Carlo spread over 128000 proposals is ~0.005).
    assert 0.1 < accs[0] < 0.6 and abs(accs[0] - accs[1]) < 0.02, accs
