"""The port's walk and KDE moves against the JAX package: the walk
move's shared-covariance step and its subset step under injected draws,
the KDE log-density and bandwidth factors on the same numpy ``x``, ``c``
and Cholesky factor, and the statistical oracles of
``tests/integration/test_walk.py`` and ``test_kde.py`` (one per move in
the fast tier, the rest ``slow``).

Both packages compute in float32; the covariance, Cholesky and matmul
round in other orders, hence rtol 1e-5 (1e-4 for the log-density, a
logsumexp over a few hundred kernels)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from emcee_tpu import moves as jmoves
from emcee_tpu.moves.walk import _cov as jax_cov

from emcee_tpu_torch import moves
from emcee_tpu_torch.model import Model, wrap_log_prob_fn
from emcee_tpu_torch.moves.kde import kde_logpdf
from emcee_tpu_torch.moves.walk import cholesky_or_nan, complement, cov
from emcee_tpu_torch.ops.philox import (
    SUBSAMPLE_BLOCK, normals, row_uniforms, to_uniform, walker_words)
from tests.test_torch_sampler import _test_normal, _test_uniform

NW, ND = 40, 3


def lp_batch(x):
    return -0.5 * (x**2).sum(-1)


def model():
    return Model(wrap_log_prob_fn(lp_batch, vectorize=True), NW, ND)


def coords(seed=0):
    return np.random.default_rng(seed).normal(size=(NW, ND)).astype(
        np.float32)


@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("scale", [None, 0.6])
def test_walk_shared_covariance_step_matches_jax(split, scale):
    x = coords(1)
    ng = NW // 2
    z = np.random.default_rng(2).normal(size=(ng, ND)).astype(np.float32)
    mv = moves.WalkMove()
    q, f = mv.get_proposal((1, 2), torch.from_numpy(x), split, model(),
                           extra={"z": torch.from_numpy(z)},
                           scale=None if scale is None else torch.tensor(
                               scale))
    s = x[split * ng:(split + 1) * ng]
    c = np.concatenate([x[:split * ng], x[(split + 1) * ng:]])
    chol = jnp.linalg.cholesky(jax_cov(jnp.asarray(c)))
    adj = 1.0 if scale is None else jnp.float32(scale)
    want = np.asarray(jnp.asarray(s) + adj * (jnp.asarray(z) @ chol.T))
    np.testing.assert_allclose(q.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not f.any()


def test_walk_draws_from_its_counter_blocks():
    x = torch.from_numpy(coords(3))
    ng = NW // 2
    q, _ = moves.WalkMove().get_proposal((5, 7), x, 1, model())
    z = normals(ng, ND, 5, 7, "cpu", row0=ng)
    q2, _ = moves.WalkMove().get_proposal((5, 7), x, 1, model(),
                                          extra={"z": z})
    assert torch.equal(q, q2)


@pytest.mark.parametrize("exact_subset_max", [4096, 4])
def test_walk_subset_step_is_the_subset_covariance(exact_subset_max):
    """``dz = X_c^T z / sqrt(s0 - 1)``: with the picks and normals
    injected, the step is that formula; its covariance over z is exactly
    ``Cov(subset)`` (``X_c^T X_c / (s0 - 1)``), singular or not."""
    x = torch.from_numpy(coords(4))
    ng, s0 = NW // 2, 3
    mv = moves.WalkMove(s=s0, exact_subset_max=exact_subset_max)
    q, _ = mv.get_proposal((8, 9), x, 0, model())
    c = complement(x, 0, ng)
    nc = c.shape[0]
    if exact_subset_max >= nc:
        keys = row_uniforms(ng, nc, 8, 9, "cpu")
        picks = torch.argsort(keys, dim=1, stable=True)[:, :s0]
        assert all(len(set(p.tolist())) == s0 for p in picks)
    else:
        u = row_uniforms(ng, s0, 8, 9, "cpu")
        picks = torch.clamp((u * nc).to(torch.int64), max=nc - 1)
    z = normals(ng, s0, 8, 9, "cpu")
    q2, _ = mv.get_proposal((8, 9), x, 0, model(),
                            extra={"picks": picks, "z": z})
    assert torch.equal(q, q2)
    sub = c[picks].numpy().astype(np.float64)
    xc = sub - sub.mean(axis=1, keepdims=True)
    want = x[:ng].numpy() + np.einsum("gs,gsd->gd", z.numpy(), xc) / np.sqrt(
        s0 - 1)
    np.testing.assert_allclose(q.numpy(), want, rtol=1e-5, atol=1e-5)
    # Cov over z of X_c^T z / sqrt(s0 - 1) is X_c^T X_c / (s0 - 1).
    for g in range(3):
        np.testing.assert_allclose(xc[g].T @ xc[g] / (s0 - 1),
                                   np.cov(sub[g], rowvar=False), atol=1e-12)


def test_cholesky_or_nan():
    a = np.array([[2.0, 0.5], [0.5, 1.0]], dtype=np.float32)
    np.testing.assert_allclose(cholesky_or_nan(torch.from_numpy(a)).numpy(),
                               np.linalg.cholesky(a), rtol=1e-6)
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    assert torch.isnan(cholesky_or_nan(bad)).all()


@pytest.mark.parametrize("n,nc", [(7, 5), (30, 200)])
@pytest.mark.parametrize("block_bytes", [None, 64])
def test_kde_logpdf_matches_jax(n, nc, block_bytes):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, ND)).astype(np.float32)
    c = rng.normal(size=(nc, ND)).astype(np.float32)
    a = rng.normal(size=(ND, ND))
    chol = np.linalg.cholesky(0.3 * (a @ a.T / ND + np.eye(ND))).astype(
        np.float32)
    kw = {} if block_bytes is None else {"block_bytes": block_bytes}
    got = kde_logpdf(torch.from_numpy(x), torch.from_numpy(c),
                     torch.from_numpy(chol), **kw)
    want = np.asarray(jmoves.KDEMove._logpdf(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(chol)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # One block, or many: each row's logsumexp is one reduction, and only
    # the matmul's rounding may differ with the block's shape.
    whole = kde_logpdf(torch.from_numpy(x), torch.from_numpy(c),
                       torch.from_numpy(chol), block_bytes=1 << 40)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("bw", [None, "scott", "silverman", 0.4])
def test_kde_bandwidth_factor_matches_jax(bw):
    for nc, d in ((20, 1), (500, 3), (5e4, 5)):
        assert moves.KDEMove(bw_method=bw)._factor(nc, d) == \
            jmoves.KDEMove(bw_method=bw)._factor(nc, d)


def test_kde_proposal_from_its_draws():
    """The resample and the Hastings factor of one split, from the
    kernel centres (word 0 at ``(i, split)``), the noise normals and the
    subsample keys, recomputed from those draws."""
    x = torch.from_numpy(coords(5))
    ng = NW // 2
    mv = moves.KDEMove(max_complement=12)
    q, f = mv.get_proposal((3, 4), x, 1, model())
    c = complement(x, 1, ng)
    keys = walker_words(c.shape[0], SUBSAMPLE_BLOCK | 1, 3, 4, "cpu")[0]
    sub = torch.argsort(keys, stable=True)[:12]
    c = c[sub]
    chol = cholesky_or_nan(mv._factor(12, ND) ** 2 * cov(c))
    u = to_uniform(walker_words(ng, 1, 3, 4, "cpu")[0])
    pick = torch.clamp((u * 12).to(torch.int64), max=11)
    noise = normals(ng, ND, 3, 4, "cpu", row0=ng)
    want_q = c[pick] + noise @ chol.T
    assert torch.equal(q, want_q)
    s = x[ng:]
    assert torch.equal(f, kde_logpdf(s, c, chol) - kde_logpdf(q, c, chol))
    q2, f2 = mv.get_proposal((3, 4), x, 1, model(),
                             extra={"sub": sub, "pick": pick,
                                    "noise": noise})
    assert torch.equal(q, q2) and torch.equal(f, f2)


def test_normal_walk():
    """The fast oracle of ``test_walk.py``."""
    _test_normal(moves.WalkMove(), nsteps=3000)


def test_normal_kde():
    """The fast oracle of ``test_kde.py``."""
    _test_normal(moves.KDEMove())


@pytest.mark.slow
def test_normal_walk_subset():
    _test_normal(moves.WalkMove(s=3), nsteps=3000)


@pytest.mark.slow
def test_uniform_walk():
    _test_uniform(moves.WalkMove())


@pytest.mark.slow
def test_normal_kde_3d():
    _test_normal(moves.KDEMove(), ndim=3)


@pytest.mark.slow
def test_uniform_kde():
    _test_uniform(moves.KDEMove())


@pytest.mark.slow
def test_normal_kde_subsampled():
    _test_normal(moves.KDEMove(max_complement=12))
