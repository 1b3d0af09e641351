"""K7, the KDE log-density (``emcee_tpu_torch/ops/kde_kernel.py``), on the
CPU: its plain version, which the wrapper runs for CPU tensors and which
the CUDA kernel (``csrc/kde_logpdf.cu``) equals bit for bit on the card
(``chip_smoke.py`` phase 19).

Against the JAX package, ``emcee_tpu.moves.KDEMove._logpdf`` on the same
numpy rows, kernels and Cholesky factor: rtol = atol = 1e-4, as
``tests/test_torch_walk_kde.py`` (float32 both; the port sums the cross
term in column order and runs a logsumexp per lane, JAX a matmul and one
reduction).  Against a float64 logsumexp of the exact squared distances
at ``nc`` = 3000: atol 5e-5 (the float32 cancellation in ``(|x'|^2 +
|c'|^2) - 2 x'.c'`` and ~94 terms a lane; the largest difference seen is
below 1e-5).  Bit for bit within the port: row sets stacked against
separate calls, the plain version's rows a pass, and the rung axis
against each rung's one-ensemble plain version.  JAX runs on the CPU
(tests/conftest.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu import moves as jmoves

from emcee_tpu_torch.moves import kde as kde_mod
from emcee_tpu_torch.moves.kde import kde_logpdf
from emcee_tpu_torch.moves.walk import cholesky_or_nan
from emcee_tpu_torch.ops import kde_kernel as kk


def inputs(n, nc, nd, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, nd)).astype(np.float32)
    c = rng.normal(size=(nc, nd)).astype(np.float32)
    a = rng.normal(size=(nd, nd))
    chol = np.linalg.cholesky(scale * (a @ a.T / nd + np.eye(nd))).astype(
        np.float32)
    return x, c, chol


def t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def bits(a):
    return a.view(torch.int32)


def same_bits(a, b):
    """Equal bit for bit, NaN included."""
    return a.shape == b.shape and torch.equal(bits(a), bits(b))


@pytest.mark.parametrize("n,nc,nd", [
    (7, 5, 3), (30, 200, 3), (9, 33, 1), (5, 1, 2), (12, 70, 17),
    (3, 64, 5), (40, 97, 5)])
def test_plain_k7_matches_jax(n, nc, nd):
    """``nc`` a multiple of 32 or not (idle lanes), one kernel, ndim 1 and
    17 (the kernel's shared-memory route on the card)."""
    x, c, chol = inputs(n, nc, nd, seed=n + nc)
    got = kde_logpdf(*t(x, c, chol))
    want = np.asarray(jmoves.KDEMove._logpdf(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(chol)))
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_plain_k7_against_float64():
    """3000 kernels (94 a lane): the running logsumexp and the butterfly
    against a float64 logsumexp of the exact squared distances."""
    n, nc, nd = 50, 3000, 5
    x, c, chol = inputs(n, nc, nd, seed=9, scale=0.05)
    got = kde_logpdf(*t(x, c, chol)).numpy()
    L = chol.astype(np.float64)
    xw = np.linalg.solve(L, x.T.astype(np.float64)).T
    cw = np.linalg.solve(L, c.T.astype(np.float64)).T
    a = -0.5 * ((xw[:, None, :] - cw[None, :, :]) ** 2).sum(-1)
    mx = a.max(axis=1, keepdims=True)
    lse = (mx + np.log(np.exp(a - mx).sum(axis=1, keepdims=True)))[:, 0]
    want = lse - (np.log(nc) + 0.5 * nd * np.log(2 * np.pi)
                  + np.log(np.diag(L)).sum())
    # the kernels are far apart in whitened units: a wide spread of terms
    assert np.ptp(a, axis=1).min() > 50
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_nan_factor_gives_nan_rows():
    """A complement that is not positive definite: its NaN factor gives
    NaN log-densities, on one ensemble and on the rung it belongs to."""
    x, c, _ = inputs(6, 40, 3)
    bad = cholesky_or_nan(torch.tensor([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0],
                                        [0.0, 0.0, 1.0]]))
    assert torch.isnan(bad).all()
    out = kde_logpdf(torch.from_numpy(x), torch.from_numpy(c), bad)
    assert torch.isnan(out).all()
    good = torch.from_numpy(inputs(6, 40, 3)[2])
    xs = torch.from_numpy(np.stack([x, x]))
    cs = torch.from_numpy(np.stack([c, c]))
    out = kde_logpdf(xs, cs, torch.stack([good, bad]))
    assert torch.isfinite(out[0]).all() and torch.isnan(out[1]).all()


def test_every_term_underflows():
    """Rows far from every kernel (every exp(a) below float32's range)
    keep their log-density through the running max."""
    x, c, chol = inputs(4, 64, 2)
    x = x + 300.0
    got = kde_logpdf(*t(x, c, chol))
    want = np.asarray(jmoves.KDEMove._logpdf(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(chol)))
    assert np.all(want < -1e4) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("n_s,n_q,nc", [(8, 8, 40), (5, 11, 33)])
def test_stacked_row_sets_equal_separate_calls(n_s, n_q, nc):
    """``s`` and ``q`` in one launch (as ``KDEMove`` evaluates them)
    against one call each, bit for bit."""
    x, c, chol = inputs(n_s + n_q, nc, 3, seed=3)
    s, q = torch.from_numpy(x[:n_s]), torch.from_numpy(x[n_s:])
    c, chol = torch.from_numpy(c), torch.from_numpy(chol)
    ls, lq = kde_mod._logpdfs((s, q), c, chol)
    assert same_bits(ls, kde_logpdf(s, c, chol))
    assert same_bits(lq, kde_logpdf(q, c, chol))


@pytest.mark.parametrize("rows", [1, 7, 1000])
def test_plain_rows_a_pass_change_nothing(rows):
    x, c, chol = t(*inputs(20, 45, 4, seed=4))
    xw, cw = kde_mod._whiten(x, chol), kde_mod._whiten(c, chol)
    norm = torch.tensor(0.25)
    assert same_bits(kk.kde_logpdf_plain(xw, cw, norm, rows),
                     kk.kde_logpdf_plain(xw, cw, norm))


@pytest.mark.parametrize("T", [1, 3])
def test_plain_rung_axis_equals_each_rung_alone(T):
    """The rung axis of the plain version (every rung's rows, kernels and
    normaliser at once) against the one-ensemble plain version of each
    rung, bit for bit; one rung's rows NaN leave the others alone."""
    gen = torch.Generator().manual_seed(T)
    n, nc, nd = 9, 37, 3
    x = torch.randn(T, n, nd, generator=gen)
    c = 1.5 * torch.randn(T, nc, nd, generator=gen)
    norm = torch.randn(T, generator=gen)
    x[-1, 2, 1] = float("nan")
    out = kk.kde_logpdf_plain(x, c, norm)
    assert out.shape == (T, n)
    for r in range(T):
        assert same_bits(out[r], kk.kde_logpdf_plain(x[r], c[r], norm[r]))
    assert torch.isnan(out[-1, 2]) and int(torch.isnan(out).sum()) == 1


def test_wrapper_runs_the_plain_version_on_the_cpu_only():
    x, c, chol = t(*inputs(5, 40, 2))
    before = kk.kde_logpdf.launches
    xw, cw = kde_mod._whiten(x, chol), kde_mod._whiten(c, chol)
    norm = torch.tensor(1.0)
    assert same_bits(kk.kde_logpdf(xw, cw, norm),
                     kk.kde_logpdf_plain(xw, cw, norm))
    assert kk.kde_logpdf.launches == before  # the plain version launches none
    with pytest.raises(ValueError, match="no K7 kernel"):
        kk.kde_logpdf(xw.to("meta"), cw.to("meta"), norm.to("meta"))


@pytest.mark.parametrize("n,nd,rungs", [
    (100_000, 5, 1), (256, 5, 16), (1, 1, 1), (5003, 3, 3), (300, 17, 2),
    (1000, 128, 1), (31, 100, 64)])
def test_kde_plan(n, nd, rungs):
    """Rows a warp from 8 down while the card has too few blocks, tiles of
    32 kernels or more within the shared-memory cap, the shared memory the
    kernel's layout needs."""
    n_sm = 132
    p = kk.kde_plan(n, nd, n_sm, rungs)
    assert p.rows in (1, 2, 4, 8) and p.warps == kk.KDE_WARPS
    assert p.tile % 32 == 0 and 32 <= p.tile <= kk.KDE_TILE
    assert p.smem == kk.kde_smem(nd, p.rows, p.warps, p.tile)
    assert p.smem <= kk.KDE_SMEM_MAX
    blocks = rungs * -(-n // (p.warps * p.rows))
    if p.rows > 1:
        assert blocks >= kk.KDE_BLOCKS_PER_SM * n_sm
    if p.rows < 8:
        bigger = rungs * -(-n // (p.warps * p.rows * 2))
        assert bigger < kk.KDE_BLOCKS_PER_SM * n_sm
    if nd == 128:
        assert p.smem > 48 * 1024  # the kernel's opt-in path
    if (n, nd, rungs) == (100_000, 5, 1):
        assert p == (8, 4, 256, 6144)
    if (n, nd, rungs) == (256, 5, 16):
        assert p.rows == 2
