"""The port's Metropolis-Hastings and Gaussian moves against the JAX
package: the accept through K2 at ``nsplits=1`` under injected uniforms,
the Gaussian step under injected normals, its masks and its
``sequential`` cycle, the constructor's errors, and the statistical
oracle of ``tests/integration/test_gaussian.py`` (one per move in the
fast tier, the rest ``slow``).

The Gaussian step is float32 arithmetic in both packages: the full
covariance's matmul may round in another order, hence rtol 1e-6."""

from itertools import product

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from emcee_tpu import moves as jmoves

import emcee_tpu_torch
from emcee_tpu_torch import State, moves
from emcee_tpu_torch.model import Model, wrap_log_prob_fn
from emcee_tpu_torch.moves.gaussian import gaussian_step
from emcee_tpu_torch.ops.philox import normals, to_uniform, walker_words
from tests.test_torch_sampler import _test_normal, _test_uniform

NW, ND = 24, 3


def lp_batch(x):
    return -0.5 * (x**2).sum(-1)


def model():
    return Model(wrap_log_prob_fn(lp_batch, vectorize=True), NW, ND)


def ensemble(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(NW, ND)).astype(np.float32)
    return x, (-0.5 * (x.astype(np.float64) ** 2).sum(-1)).astype(np.float32)


def philox_mh(rng, x):
    """A user proposal on the port's Philox helpers."""
    seed, offset = rng
    z = normals(x.shape[0], x.shape[1], seed, offset, x.device)
    return x + 0.5 * z, torch.zeros(x.shape[0])


def test_mh_accept_through_k2_matches_log_u_rule():
    x, lp = ensemble(1)
    rng = np.random.default_rng(2)
    q = (x + rng.normal(size=x.shape)).astype(np.float32)
    factors = rng.normal(size=NW).astype(np.float32) * 0.1
    log_u = np.log(rng.uniform(size=NW)).astype(np.float32)
    mv = moves.MHMove(lambda rng_, c: (torch.from_numpy(q),
                                       torch.from_numpy(factors)))
    st = State(torch.from_numpy(x.copy()), torch.from_numpy(lp.copy()))
    count = torch.zeros(NW, dtype=torch.int32)
    st, acc, _ = mv.propose((3, 4), st, model(), (), count,
                            log_u=torch.from_numpy(log_u))
    lp_q = lp_batch(torch.from_numpy(q)).numpy()
    # K2's order (factor + lp_q) - lp; JAX's (lp_q - lp) + factor agrees
    # except within an ulp of the threshold.
    want = log_u < (factors + lp_q) - lp
    jax_rule = np.asarray(jnp.asarray(lp_q) - jnp.asarray(lp)
                          + jnp.asarray(factors))
    assert np.mean(want == (log_u < jax_rule)) == 1.0
    np.testing.assert_array_equal(acc.numpy(), want)
    np.testing.assert_array_equal(count.numpy(), want.astype(np.int32))
    np.testing.assert_array_equal(st.coords.numpy(),
                                  np.where(want[:, None], q, x))
    np.testing.assert_array_equal(st.log_prob.numpy(),
                                  np.where(want, lp_q, lp))
    assert 0 < want.sum() < NW


def test_mh_draws_k2_word_one_and_checks_ndim():
    x, lp = ensemble(3)
    mv = moves.MHMove(philox_mh)
    seed, offset = 11, 7
    st = State(torch.from_numpy(x.copy()), torch.from_numpy(lp.copy()))
    st, acc, _ = mv.propose((seed, offset), st, model(), ())
    z = normals(NW, ND, seed, offset, "cpu").numpy()
    q = x + 0.5 * z
    lp_q = np.asarray(lp_batch(torch.from_numpy(q)))
    u = to_uniform(walker_words(NW, 0, seed, offset, "cpu")[1]).numpy()
    want = np.log(u) < (0.0 + lp_q) - lp
    np.testing.assert_array_equal(acc.numpy(), want)
    with pytest.raises(ValueError, match="Dimension mismatch"):
        moves.MHMove(philox_mh, ndim=ND + 1).propose(
            (1, 2), State(torch.from_numpy(x), torch.from_numpy(lp)),
            model(), ())


@pytest.mark.parametrize("cov", ["scalar", "diag", "full"])
@pytest.mark.parametrize("factor", [1.0, 0.7])
def test_gaussian_step_matches_jax_formula(cov, factor):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(NW, ND)).astype(np.float32)
    z = rng.normal(size=(NW, ND)).astype(np.float32)
    a = rng.normal(size=(ND, ND))
    c = {"scalar": 0.5, "diag": 0.5 + rng.uniform(size=ND),
         "full": a @ a.T / ND + 0.5 * np.eye(ND)}[cov]
    mv = moves.GaussianMove(c)
    jm = jmoves.GaussianMove(c)
    scale, chol = mv._tensors("cpu", torch.float32)
    got = gaussian_step(torch.from_numpy(x), torch.from_numpy(z), scale,
                        chol, torch.tensor(factor), "vector")
    jz = jnp.asarray(z)
    step = (jz @ jnp.asarray(jm._chol, dtype=jnp.float32).T
            if cov == "full" else jz * jnp.asarray(jm._scale, jnp.float32))
    want = np.asarray(jnp.asarray(x) + jnp.float32(factor) * step)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_gaussian_random_mode_mask():
    x, lp = ensemble(5)
    mv = moves.GaussianMove(0.5, mode="random")
    seed, offset = 21, 9
    q, f, carry = mv.get_proposal((seed, offset), torch.from_numpy(x), {})
    u = to_uniform(walker_words(NW, 0, seed, offset, "cpu")[0])
    dims = torch.clamp((u * ND).to(torch.int64), max=ND - 1).numpy()
    z = normals(NW, ND, seed, offset, "cpu").numpy()
    changed = q.numpy() != x
    np.testing.assert_array_equal(changed, np.eye(ND, dtype=bool)[dims])
    rows = np.arange(NW)
    np.testing.assert_array_equal(
        q.numpy()[rows, dims],
        (x[rows, dims] + np.float32(np.sqrt(0.5)) * z[rows, dims]))
    assert len(set(dims)) == ND and not f.any() and carry == {}


def test_gaussian_sequential_cycles_through_dims():
    """The sequential dimension is a 0-d int32 carry, advanced in place:
    proposal k changes only dimension k % ndim, for every walker, and a
    run resumes the cycle where it stopped."""
    mv = moves.GaussianMove(0.5 * np.ones(ND), mode="sequential")
    carry = mv.init_carry(NW, ND)
    index = carry["index"]
    x = torch.from_numpy(ensemble(6)[0])
    for k in range(2 * ND + 1):
        q, _, out = mv.get_proposal((1, k), x, carry)
        assert out is carry and carry["index"] is index
        changed = (q != x).numpy()
        assert changed[:, k % ND].all() and not np.delete(
            changed, k % ND, axis=1).any()
        assert int(index) == (k + 1) % ND
    s = emcee_tpu_torch.EnsembleSampler(
        NW, ND, lp_batch, vectorize=True, device="cpu", seed=2,
        moves=moves.GaussianMove(0.5, mode="sequential"))
    s.run_mcmc(ensemble(7)[0], 4)
    assert int(s._move_carries[0]["index"]) == 4 % ND
    s.run_mcmc(None, 3)
    assert int(s._move_carries[0]["index"]) == 7 % ND
    assert np.diff(s.get_chain(), axis=0)[:, :, 1].any()


def test_gaussian_factor_and_tuning():
    x = torch.from_numpy(ensemble(8)[0])
    mv = moves.GaussianMove(0.5, factor=3.0)
    q1, _, _ = mv.get_proposal((4, 2), x, {})
    q2, _, _ = moves.GaussianMove(0.5).get_proposal((4, 2), x, {})
    # One factor for every walker and dimension; the steps are recovered
    # by a float32 subtraction of x, which costs digits: rtol 1e-3.
    ratio = ((q1 - x) / (q2 - x)).numpy()
    np.testing.assert_allclose(ratio, ratio.flat[0], rtol=1e-3)
    assert 1 / 3 <= ratio.flat[0] <= 3 and ratio.flat[0] != 1
    s = emcee_tpu_torch.EnsembleSampler(
        NW, ND, lp_batch, vectorize=True, device="cpu", seed=2,
        moves=moves.GaussianMove(4.0, tune_target=0.4))
    s.run_mcmc(ensemble(9)[0], 30, tune=True)
    carry = s._move_carries[0]
    assert int(carry["t"]) == 30 and float(carry["log_adj"]) < 0


def test_invalid_gaussian_arguments():
    for kw in (dict(cov=0.5, mode="not-a-mode"), dict(cov=np.eye(3),
                                                      mode="random"),
               dict(cov=0.5, factor=0.5), dict(cov=np.ones((2, 3)))):
        with pytest.raises(ValueError):
            moves.GaussianMove(**kw)
        with pytest.raises(ValueError):
            jmoves.GaussianMove(**kw)


def test_normal_gaussian():
    """The fast oracle of ``test_gaussian.py``: vector mode, 1-D."""
    _test_normal(moves.GaussianMove(0.5))


def test_normal_mh_on_philox_helpers():
    """The fast oracle of the MH move: a user proposal drawing from the
    port's Philox normals."""
    _test_normal(moves.MHMove(philox_mh))


@pytest.mark.slow
@pytest.mark.parametrize("mode,factor", product(["vector"], [2.0, 5.0]))
def test_normal_gaussian_factor(mode, factor):
    _test_normal(moves.GaussianMove(0.5, mode=mode, factor=factor))


@pytest.mark.slow
@pytest.mark.parametrize(
    "mode,factor", product(["vector", "random", "sequential"], [None, 2.0])
)
def test_normal_gaussian_nd(mode, factor):
    """``test_gaussian.py``'s 3-D oracle: isotropic, axis-aligned, the
    dimension-mismatch error, and the full matrix in vector mode."""
    ndim, nsteps = 3, 8000
    _test_normal(moves.GaussianMove(0.5, factor=factor, mode=mode),
                 ndim=ndim, nsteps=nsteps)
    _test_normal(moves.GaussianMove(0.5 * np.ones(ndim), factor=factor,
                                    mode=mode), ndim=ndim, nsteps=nsteps)
    with pytest.raises(ValueError):
        _test_normal(moves.GaussianMove(0.5 * np.ones(ndim - 1),
                                        factor=factor, mode=mode),
                     ndim=ndim, nsteps=nsteps)
    if mode == "vector":
        _test_normal(moves.GaussianMove(np.diag(0.5 * np.ones(ndim)),
                                        mode=mode), ndim=ndim, nsteps=nsteps)


@pytest.mark.slow
def test_uniform_gaussian():
    _test_uniform(moves.GaussianMove(0.5))
