"""K8, DIME's moments, factor and proposal (``emcee_tpu_torch/ops/
dime_kernel.py``): each plain version against the JAX package on the CPU,
on the same numpy inputs.

* K8a + K8b (``dime_moments_plain``, ``dime_finish_plain``) against
  ``_centered_moments`` / ``_pooled`` / ``_t_shape_chol`` and the
  triangular inverse (one component), ``_mixture_quantities`` (two and
  three), and ``update_carry``, at a cold start (``w = 0``) and a warm
  carry, with an ensemble at mean 1e4 and spread 1, where moments formed
  as ``E[xx^T] - mu mu^T`` would cancel (the components' clusters 20
  apart there, far from equidistant: the JAX package assigns by ``|x|^2 -
  2 x . mu + |mu|^2``, K8a by ``|x - mu|^2``, ROADMAP.md section 3);
* K8c (``dime_propose_plain``) against ``get_proposal`` under JAX's own
  draws, injected, for ``df`` None, 10 and 7.5 and ``aimh_prob`` 0.3 and
  1.0, one and two components;
* a shape that is not positive definite: every entry of the factor NaN in
  both packages;
* within the port, bit for bit: the rung axis ``(T, n, nd)`` against each
  rung alone (moments, table, carry update, proposal from the stream);
  and two plans (the rows a K8a block reduces) agree to rounding.

Tolerance rtol = atol = 1e-5, 2e-5 for the mixture (as
``tests/test_torch_dime.py``): the sums run in other orders than XLA's.
With a warm carry at mean 1e4 the pooled second moments hold the history
term ``(rho w n / total^2) delta delta^T``, ``delta`` the batch mean less
the carry's; float32 holds a mean there to its spacing (2^-10), and the
two packages sum the mean in other orders, so those comparisons add
``4 spacing max|delta| max(rho w n / total^2)`` to the absolute
tolerance (:func:`history_atol`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu import moves as jmoves
from emcee_tpu.state import State as JState

from emcee_tpu_torch.ops import dime_kernel as dk
from emcee_tpu_torch.ops.de_kernel import de_gamma0
from emcee_tpu_torch.ops.philox import rung_keys
from tests.test_torch_dime import jax_dime_draws, jmodel

TOL = 1e-5
NW, ND = 40, 3
OFFSET = 1.0e4


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), tol, tol)


def cfg_of(move, nd=ND):
    return dk.DimeConfig(move.n_components, move.rho, move.df,
                         move.aimh_prob, de_gamma0(move.gamma0, nd),
                         move.sigma)


def ensemble(rng, k, n=NW, nd=ND, offset=OFFSET):
    """``n`` rows of spread 1 at ``offset``, in ``k`` clusters 20 apart,
    each a run of rows from a multiple of ``n // k`` (the cold start's
    strided rows fall one in each)."""
    x = rng.normal(size=(n, nd))
    x += offset + 20.0 * np.minimum(np.arange(n) // (n // k), k - 1)[:, None]
    return x.astype(np.float32)


def history_atol(carry, batch_means, n, rho=0.999):
    """The absolute tolerance of the pooled second moments and factors:
    1e-5, plus the history term's share of the means' float32 spacing
    (the module docstring)."""
    w = np.atleast_1d(np.asarray(carry["w"], np.float64)) * rho
    coef = np.max(w * n / (w + n) ** 2)
    delta = np.max(np.abs(np.asarray(batch_means, np.float64)
                          - np.asarray(carry["mean"], np.float64)))
    spacing = np.spacing(np.float32(np.max(np.abs(batch_means))))
    return TOL + 4.0 * float(spacing) * delta * coef


def carry_of(rng, k, warm, nd=ND, offset=OFFSET):
    """A carry of ``k`` components: the cold one, or moments near the
    clusters with weight."""
    lead = (k,) if k > 1 else ()
    if not warm:
        return {"mean": np.zeros(lead + (nd,), np.float32),
                "cov": np.broadcast_to(np.eye(nd, dtype=np.float32),
                                       lead + (nd, nd)).copy(),
                "w": np.zeros(lead, np.float32)}
    mean = (offset + 20.0 * np.arange(k)[:, None]
            + 0.3 * rng.normal(size=(k, nd))).astype(np.float32)
    a = rng.normal(size=(k, nd, nd)) * 0.3
    cov = (np.eye(nd) + a @ np.swapaxes(a, 1, 2)).astype(np.float32)
    w = rng.uniform(20, 60, size=k).astype(np.float32)
    if k == 1:
        return {"mean": mean[0], "cov": cov[0], "w": w[0]}
    return {"mean": mean, "cov": cov, "w": w}


def port(c):
    return {k: t(v) for k, v in c.items()}


def jx(c):
    return {k: jnp.asarray(v) for k, v in c.items()}


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("df", [None, 10.0])
def test_one_component_moments_factor_and_update_match_jax(warm, df):
    rng = np.random.default_rng(11 + 2 * warm + (df is None))
    jmove = jmoves.DIMEMove(df=df)
    x = ensemble(rng, 1)
    carry = carry_of(rng, 1, warm)
    ng = NW // 2
    for split in (0, 1):
        c = np.concatenate([x[:split * ng], x[(split + 1) * ng:]])
        mean_c, cov_c = jmoves.dime._centered_moments(jnp.asarray(c))
        mean, cov, _ = jmove._pooled(jx(carry), mean_c, cov_c, NW - ng,
                                     jnp.float32)
        L = jmove._t_shape_chol(cov, ND, jnp.float32)
        Li = jax.scipy.linalg.solve_triangular(L, jnp.eye(ND), lower=True)
        pc = port(carry)
        part = dk.dime_moments_plain(t(x), (split * ng, ng), pc["mean"],
                                     pc["w"], 1)
        table = dk.dime_finish_plain(part, pc["mean"], pc["cov"], pc["w"],
                                     cfg_of(jmove))
        got = dk.unpack_table(table, 1, ND)
        atol = history_atol(carry, mean_c, NW - ng)
        close(got[0][0], mean)
        for g, w in ((got[1][0], L), (got[2][0], Li)):
            np.testing.assert_allclose(g, np.asarray(w), TOL, atol)
    want = jmove.update_carry(jx(carry), JState(jnp.asarray(x)), jmodel())
    pc = port(carry)
    dk.dime_finish_plain(dk.dime_moments_plain(t(x), (0, 0), pc["mean"],
                                               pc["w"], 1),
                         pc["mean"], pc["cov"], pc["w"], cfg_of(jmove),
                         mode="update")
    atol = history_atol(carry, np.asarray(x).mean(0), NW)
    for key in ("mean", "cov", "w"):
        np.testing.assert_allclose(pc[key], np.asarray(want[key]), TOL,
                                   atol)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("k", [2, 3])
def test_mixture_quantities_and_update_match_jax(warm, k):
    rng = np.random.default_rng(20 + k + 5 * warm)
    jmove = jmoves.DIMEMove(n_components=k)
    x = ensemble(rng, k)
    carry = carry_of(rng, k, warm)
    pc = port(carry)
    part = dk.dime_moments_plain(t(x), (0, 0), pc["mean"], pc["w"], k)
    table = dk.dime_finish_plain(part, pc["mean"], pc["cov"], pc["w"],
                                 cfg_of(jmove))
    got = dk.unpack_table(table, k, ND)
    want = jmove._mixture_quantities(jx(carry), jnp.asarray(x), jmodel(),
                                     jnp.float32)
    n_k, mb, _ = jmove._masked_moments(
        jnp.asarray(x), jmove._assign_means(jx(carry), jnp.asarray(x),
                                            jmodel()), jmodel())
    atol = history_atol(carry, mb, np.asarray(n_k)) + TOL
    for g, w in zip(got[:5], want):
        np.testing.assert_allclose(g, np.asarray(w), 2 * TOL, atol)
    close(got[5], np.cumsum(np.exp(np.asarray(want[3]))), 2 * TOL)
    want = jmove.update_carry(jx(carry), JState(jnp.asarray(x)), jmodel())
    dk.dime_finish_plain(part, pc["mean"], pc["cov"], pc["w"], cfg_of(jmove),
                         mode="update")
    for key in ("mean", "cov", "w"):
        np.testing.assert_allclose(pc[key], np.asarray(want[key]), 2 * TOL,
                                   atol)


@pytest.mark.parametrize("df", [None, 10.0, 7.5])
@pytest.mark.parametrize("aimh_prob", [0.3, 1.0])
@pytest.mark.parametrize("k", [1, 2])
def test_proposal_matches_jax_under_its_draws(df, aimh_prob, k):
    rng = np.random.default_rng(30 + k)
    kw = dict(df=df, aimh_prob=aimh_prob, n_components=k)
    jmove = jmoves.DIMEMove(**kw)
    x = ensemble(rng, k, offset=0.0) * 0.5
    carry = carry_of(rng, k, True, offset=0.0)
    ng, split = NW // 2, 1
    s, c = x[ng:], x[:ng]
    key = jax.random.key(7 + k)
    jq, jf = jmove.get_proposal(key, jnp.asarray(s), (c,), jmodel(),
                                carry=jx(carry))
    logw = None
    if k > 1:
        logw = jmove._mixture_quantities(jx(carry), jnp.asarray(c), jmodel(),
                                         jnp.float32)[3]
    draws = jax_dime_draws(key, jmove, ng, ND, NW - ng, logw)
    pc = port(carry)
    cfg = cfg_of(jmove)
    part = dk.dime_moments_plain(t(x), (split * ng, ng), pc["mean"],
                                 pc["w"], k)
    table = dk.dime_finish_plain(part, pc["mean"], pc["cov"], pc["w"], cfg)
    q, f = dk.dime_propose_plain(t(x), split, 2, table, 1, 2, cfg,
                                 extra=draws)
    close(q, jq)
    close(f, jf, 2 * TOL)


def test_not_positive_definite_gives_a_nan_factor_in_both():
    """A history that outweighs the batch with a negative-definite shape:
    the pooled t-shape has no factor: NaN on and below the diagonal in the
    JAX package (its upper triangle 0), every entry NaN in the port (as
    ``cholesky_ex`` with ``info != 0`` gave it before K8)."""
    rng = np.random.default_rng(5)
    x = ensemble(rng, 1, offset=0.0)
    carry = {"mean": np.zeros(ND, np.float32),
             "cov": -50.0 * np.eye(ND, dtype=np.float32),
             "w": np.float32(1000.0)}
    jmove = jmoves.DIMEMove()
    mean_c, cov_c = jmoves.dime._centered_moments(jnp.asarray(x))
    _, cov, _ = jmove._pooled(jx(carry), mean_c, cov_c, NW, jnp.float32)
    jl = np.asarray(jmove._t_shape_chol(cov, ND, jnp.float32))
    assert np.all(np.isnan(jl[np.tril_indices(ND)]))
    pc = port(carry)
    table = dk.dime_finish_plain(
        dk.dime_moments_plain(t(x), (0, 0), None, None, 1), pc["mean"],
        pc["cov"], pc["w"], cfg_of(jmove))
    _, L, Li, _, logdet, _ = dk.unpack_table(table, 1, ND)
    assert torch.isnan(L).all() and torch.isnan(Li).all()
    assert torch.isnan(logdet).all()


@pytest.mark.parametrize("k,df,aimh", [(1, 10.0, 0.3), (2, 7.5, 0.3),
                                       (3, None, 1.0)])
def test_rung_axis_equals_each_rung_alone(k, df, aimh):
    """Moments, table, carry update and a proposal from the stream on
    ``(T, nw, nd)`` rows against each rung alone, bit for bit."""
    Tn, nw, nd = 3, 24, 2
    rng = np.random.default_rng(40 + k)
    x = t(np.stack([ensemble(rng, k, nw, nd, offset=3.0 * r)
                    for r in range(Tn)]))
    carries = [carry_of(rng, k, r > 0, nd, offset=3.0 * r)
               for r in range(Tn)]
    stacked = {key: torch.stack([t(c[key]) for c in carries])
               for key in carries[0]}
    cfg = dk.DimeConfig(k, 0.999, df, aimh, de_gamma0(None, nd), 1e-5)
    keys = rung_keys(9, Tn, "cpu")
    ng = nw // 2
    part = dk.dime_moments_plain(x, (ng, ng), stacked["mean"],
                                 stacked["w"], k)
    table = dk.dime_finish_plain(part, stacked["mean"], stacked["cov"],
                                 stacked["w"], cfg)
    q, f = dk.dime_propose_plain(x, 1, 2, table, keys, 5, cfg)
    for r in range(Tn):
        pc = port(carries[r])
        pr = dk.dime_moments_plain(x[r], (ng, ng), pc["mean"], pc["w"], k)
        assert torch.equal(pr, part[r])
        tr = dk.dime_finish_plain(pr, pc["mean"], pc["cov"], pc["w"], cfg)
        assert torch.equal(tr, table[r])
        qr, fr = dk.dime_propose_plain(x[r], 1, 2, tr, keys.seeds[r], 5, cfg)
        assert torch.equal(qr, q[r]) and torch.equal(fr, f[r])
    whole = dk.dime_moments_plain(x, (0, 0), stacked["mean"], stacked["w"],
                                  k)
    dk.dime_finish_plain(whole, stacked["mean"], stacked["cov"],
                         stacked["w"], cfg, mode="update")
    for r in range(Tn):
        pc = port(carries[r])
        dk.dime_finish_plain(dk.dime_moments_plain(
            x[r], (0, 0), pc["mean"], pc["w"], k), pc["mean"], pc["cov"],
            pc["w"], cfg, mode="update")
        for key in pc:
            assert torch.equal(pc[key], stacked[key][r]), key


@pytest.mark.parametrize("k", [1, 3])
def test_two_plans_agree_to_rounding(k):
    """The rows a K8a block reduces set the partials and the tree: runs of
    4 rows (an 8-level tree at 1000 rows) against the plan's one block."""
    rng = np.random.default_rng(50 + k)
    x = t(ensemble(rng, k, n=1000))
    carry = port(carry_of(rng, k, True))
    cfg = dk.DimeConfig(k, 0.999, 10.0, 0.3, 0.5, 1e-5)
    tables = []
    for rows in (None, 4):
        part = dk.dime_moments_plain(x, (100, 300), carry["mean"],
                                     carry["w"], k, rows=rows)
        assert part.shape[-3] == dk.dime_plan(700, ND, k, rows).blocks
        tables.append(dk.dime_finish_plain(part, carry["mean"],
                                           carry["cov"], carry["w"], cfg))
    got, want = (dk.unpack_table(tb, k, ND) for tb in tables)
    atol = history_atol({k2: v.numpy() for k2, v in carry.items()},
                        got[0].numpy(), 700 / k)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, TOL, atol)
