"""The port's DIME move against the JAX package.

The moment machinery (``_pooled``, ``_pooled_k``, ``_masked_moments``,
``_mixture_quantities``, ``_mixture_logq``) on the same numpy inputs, and
the proposal under JAX's own draws (reproduced from the same key and
injected), for both ``df`` settings and one or two components; then
``update_carry`` chained over 20 proposals, each compared from the
port's own carry and state (float32 rounding compounds along a chain,
ROADMAP section 3).  Tolerance rtol = atol = 1e-5 (2e-5 for the mixture
log-densities and the factors, which pass through a Cholesky factor, its
triangular inverse and a logsumexp that round in other orders).  Then
both chi-square routes against the chi-square law (K-S), and the
statistical oracles of ``tests/integration/test_dime.py`` (one in the
fast tier).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

torch.set_num_threads(1)

from emcee_tpu import moves as jmoves
from emcee_tpu.model import Model as JModel
from emcee_tpu.state import State as JState

import emcee_tpu_torch
from emcee_tpu_torch import convert, moves
from emcee_tpu_torch.model import Model, wrap_log_prob_fn
from emcee_tpu_torch.moves import dime as dime_mod
from emcee_tpu_torch.moves.dime import MT_CANDIDATES, chi_square, full_float32
from emcee_tpu_torch.state import State
from tests.test_torch_sampler import _test_normal, _test_uniform
from tests.test_torch_slice import normal_oracle

NW, ND = 40, 3
TOL = 1e-5


def lp_batch(x):
    return -0.5 * (x**2).sum(-1)


def model(nw=NW, nd=ND):
    return Model(wrap_log_prob_fn(lp_batch, vectorize=True), nw, nd)


def jmodel(nw=NW, nd=ND):
    return JModel(lambda x: (-0.5 * jnp.sum(x**2, axis=-1), None),
                  nwalkers=nw, ndim=nd)


def t(a):
    return torch.from_numpy(np.array(a))


def warm_carry(move, rng, k, steps=3):
    """A port carry after ``steps`` updates from random ensembles (w >
    0), or the cold one with ``steps=0``."""
    carry = move.init_carry(NW, ND, device="cpu")
    for _ in range(steps):
        x = rng.normal(size=(NW, ND)).astype(np.float32) * 1.5 + 0.3
        move.update_carry(carry, State(torch.from_numpy(x)), model())
    return carry


def jcarry_of(carry):
    return {k: jnp.asarray(v.numpy()) for k, v in carry.items()}


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), tol, tol)


@pytest.mark.parametrize("k", [1, 2])
def test_pooled_moments_match_jax(k):
    rng = np.random.default_rng(k)
    jmove = jmoves.DIMEMove(n_components=k)
    move = moves.DIMEMove(n_components=k)
    carry = warm_carry(move, rng, k)
    jc = jcarry_of(carry)
    x = rng.normal(size=(NW, ND)).astype(np.float32)
    if k == 1:
        mb = x.mean(0)
        cb = (x - mb).T @ (x - mb) / NW
        got = move._pooled(carry, t(mb), t(cb), NW, torch.float32)
        want = jmove._pooled(jc, jnp.asarray(mb), jnp.asarray(cb), NW,
                             jnp.float32)
    else:
        am = move._assign_means(carry, t(x))
        np.testing.assert_array_equal(
            am.numpy(), np.asarray(jmove._assign_means(
                jc, jnp.asarray(x), jmodel())))
        got_m = move._masked_moments(t(x), am)
        want_m = jmove._masked_moments(jnp.asarray(x), jnp.asarray(am),
                                       jmodel())
        for g, w in zip(got_m, want_m):
            close(g, w)
        got = move._pooled_k(carry, *got_m, torch.float32)
        want = jmove._pooled_k(jc, *want_m, jnp.float32)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("df", [None, 10.0])
@pytest.mark.parametrize("cold", [False, True])
def test_mixture_quantities_and_logq_match_jax(df, cold):
    rng = np.random.default_rng(3)
    jmove = jmoves.DIMEMove(n_components=2, df=df)
    move = moves.DIMEMove(n_components=2, df=df)
    carry = warm_carry(move, rng, 2, steps=0 if cold else 3)
    c = rng.normal(size=(NW // 2, ND)).astype(np.float32)
    c[NW // 4:] += 4.0  # two clusters, one at each cold seed row
    got = move._mixture_quantities(carry, t(c), torch.float32)
    want = jmove._mixture_quantities(jcarry_of(carry), jnp.asarray(c),
                                     jmodel(), jnp.float32)
    for g, w in zip(got, want):
        close(g, w, 2 * TOL)
    x = rng.normal(size=(17, ND)).astype(np.float32) * 2.0
    close(move._mixture_logq(t(x), *got[:1], *got[2:], ND),
          jmove._mixture_logq(jnp.asarray(x), *want[:1], *want[2:], ND),
          2 * TOL)


def jax_dime_draws(key, jmove, ng, nd, nc, logw=None):
    """The draws of ``emcee_tpu/moves/dime.py:312-345`` (or ``:388-423``
    with several components) from ``key``, as port injection keywords."""
    if jmove.n_components > 1:
        (key_sel, key_comp, key_z, key_g, key_i, key_j,
         key_dg) = jax.random.split(key, 7)
    else:
        key_sel, key_z, key_g, key_i, key_j, key_dg = jax.random.split(
            key, 6)
    d = dict(z=t(jax.random.normal(key_z, (ng, nd), dtype=jnp.float32)),
             zg=t(jax.random.normal(key_dg, (ng, 1), dtype=jnp.float32)),
             i=t(jax.random.randint(key_i, (ng,), 0, nc)),
             j=t(jax.random.randint(key_j, (ng,), 0, nc - 1)),
             use_t=t(jax.random.uniform(key_sel, (ng,), dtype=jnp.float32)
                     < jmove.aimh_prob))
    if jmove.df is not None:
        d["chi2"] = t(2.0 * jax.random.gamma(key_g, jmove.df / 2.0, (ng,),
                                             dtype=jnp.float32))
    if logw is not None:
        d["comp"] = t(jax.random.categorical(key_comp, logw, shape=(ng,)))
    return d


@pytest.mark.parametrize("df", [None, 10.0])
@pytest.mark.parametrize("aimh_prob", [0.3, 1.0])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("split", [0, 1])
def test_proposal_matches_jax_under_its_draws(df, aimh_prob, k, split):
    rng = np.random.default_rng(split + 2 * k)
    kw = dict(df=df, aimh_prob=aimh_prob, n_components=k)
    jmove, move = jmoves.DIMEMove(**kw), moves.DIMEMove(**kw)
    carry = warm_carry(move, rng, k)
    jc = jcarry_of(carry)
    x = rng.normal(size=(NW, ND)).astype(np.float32)
    ng = NW // 2
    s = x[split * ng:(split + 1) * ng]
    c = x[(1 - split) * ng:(2 - split) * ng]
    key = jax.random.key(40 + split)
    jq, jf = jmove.get_proposal(key, jnp.asarray(s), (c,), jmodel(),
                                carry=jc)
    logw = None
    if k > 1:
        logw = jmove._mixture_quantities(jc, jnp.asarray(c), jmodel(),
                                         jnp.float32)[3]
    draws = jax_dime_draws(key, jmove, ng, ND, NW - ng, logw)
    q, f = move.get_proposal((1, 2), torch.from_numpy(x), split, model(),
                             extra=draws, carry=carry)
    close(q, jq)
    close(f, jf, 2 * TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_update_carry_chained_matches_jax(k):
    """20 proposals of the port (K2 on its own stream); before each, the
    JAX update of the port's carry and post-accept state."""
    kw = dict(aimh_prob=0.3, n_components=k, randomize_split=k == 1)
    jmove, move = jmoves.DIMEMove(**kw), moves.DIMEMove(**kw)
    x = np.random.default_rng(k).normal(size=(NW, ND)).astype(np.float32)
    state = State(torch.from_numpy(x), lp_batch(torch.from_numpy(x)))
    carry = move.init_carry(NW, ND, device="cpu")
    for step in range(20):
        before = {key: v.clone() for key, v in carry.items()}
        state, _, carry = move.propose((3, step), state, model(), carry)
        want = jmove.update_carry(
            jcarry_of(before), JState(jnp.asarray(state.coords.numpy())),
            jmodel())
        for key, v in want.items():
            close(carry[key], v)
    assert float(carry["w"].sum()) > NW


def test_chi_square_routes_follow_the_law():
    """Both routes against the chi-square law by K-S (20000 draws a
    ``df``), with no Marsaglia-Tsang walker exhausting its candidates."""
    for df in (10.0, 4.0, 7.5, 3.3):
        word = torch.zeros((), dtype=torch.int64)
        x = torch.cat([chi_square(5000, df, 9, off, "cpu", exhausted=word)
                       for off in range(4)])
        assert int(word) == 0
        ks = stats.kstest(x.numpy(), stats.chi2(df).cdf)
        assert ks.pvalue > 1e-3, (df, ks)


def test_marsaglia_tsang_candidates_bound():
    """A candidate is refused with probability below 0.049 at any shape
    df / 2 > 1 (the worst is near 1), so MT_CANDIDATES = 10 candidates
    all refuse with probability below 1e-12; a walker that exhausts them
    gets ``df`` and is counted."""
    rng = np.random.default_rng(0)
    for a in (1.0 + 1e-6, 1.5, 5.0):
        d = a - 1.0 / 3.0
        c = 1.0 / np.sqrt(9.0 * d)
        x = rng.normal(size=2_000_000)
        u = rng.uniform(size=x.size)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (np.log(u) < 0.5 * x * x + d - d * v
                        + d * np.log(np.where(v > 0, v, 1.0)))
        assert 1.0 - ok.mean() < 0.049, a
    assert 0.049**MT_CANDIDATES < 1e-12
    word = torch.zeros((), dtype=torch.int64)
    saved = dime_mod.MT_CANDIDATES
    dime_mod.MT_CANDIDATES = 1
    try:
        x = chi_square(4000, 2.5, 1, 0, "cpu", exhausted=word)
    finally:
        dime_mod.MT_CANDIDATES = saved
    assert int(word) > 0
    assert int((x == 2.5).sum()) >= int(word)


def test_exhaustion_counter_is_the_one_the_proposals_write(monkeypatch):
    """The proposals count exhaustions into the counter a reader gets for
    the same device, however it names it: forced by one candidate a
    walker, a sampler run's exhaustions are read back, one counter."""
    monkeypatch.setattr(dime_mod, "MT_CANDIDATES", 1)
    mv = moves.DIMEMove(df=2.5, aimh_prob=1.0)
    s = emcee_tpu_torch.EnsembleSampler(NW, ND, lp_batch, vectorize=True,
                                        moves=mv, seed=2, device="cpu")
    s.run_mcmc(np.random.default_rng(0).normal(size=(NW, ND)), 5,
               store=False)
    assert int(mv._exhausted("cpu")) > 0
    assert mv._exhausted(torch.device("cpu")) is mv._exhausted("cpu")
    assert len(mv._exhaust_counts) == 1


def test_constructor_and_carry_match_jax():
    for kw, match in (({"aimh_prob": 1.5}, "aimh_prob"),
                      ({"df": 2.0}, "df"), ({"rho": 1.0}, "rho"),
                      ({"n_components": 0}, "n_components")):
        for mod in (moves, jmoves):
            with pytest.raises(ValueError, match=match):
                mod.DIMEMove(**kw)
    for k in (1, 3):
        jc = jmoves.DIMEMove(n_components=k).init_carry(16, 2)
        c = moves.DIMEMove(n_components=k).init_carry(16, 2, device="cpu")
        for key, v in jc.items():
            np.testing.assert_array_equal(c[key].numpy(), np.asarray(v))
            assert c[key].dtype == torch.float32
    mv = moves.DIMEMove()
    assert (mv.wants_carry, mv.blendable, mv._param_shard_ok,
            mv.df) == (True, False, False, 10.0)


def test_full_float32_restores_the_callers_precision():
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with full_float32():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)


@pytest.mark.parametrize("k", [1, 2])
def test_carry_converts_from_jax(k):
    """A JAX run's adapted moments (the JAX move's own updates) continue
    in the port, leaf for leaf."""
    jmove = jmoves.DIMEMove(n_components=k)
    jc = jmove.init_carry(NW, ND)
    rng = np.random.default_rng(k)
    for _ in range(3):
        jc = jmove.update_carry(jc, JState(jnp.asarray(
            rng.normal(size=(NW, ND)).astype(np.float32))), jmodel())
    jc = {key: np.array(v) for key, v in jc.items()}
    carry = convert.carry_from_numpy(jc, device="cpu")
    for key, v in jc.items():
        assert carry[key].numpy().dtype == v.dtype
        np.testing.assert_array_equal(carry[key].numpy(), v)
    assert float(carry["w"].sum()) > 0


def test_normal_dime():
    """The fast oracle of ``test_dime.py``."""
    _test_normal(moves.DIMEMove())


@pytest.mark.slow
def test_normal_dime_3d():
    _test_normal(moves.DIMEMove(), ndim=3)


@pytest.mark.slow
def test_normal_dime_pure_independence():
    normal_oracle(moves.DIMEMove(aimh_prob=1.0), nsteps=3000,
                  check_acceptance=False)


@pytest.mark.slow
def test_uniform_dime():
    _test_uniform(moves.DIMEMove())


@pytest.mark.slow
def test_normal_dime_blocked():
    _test_normal(moves.DIMEMove(randomize_split=False))


@pytest.mark.slow
def test_normal_dime_gaussian_proposal():
    normal_oracle(moves.DIMEMove(aimh_prob=1.0, df=None), nsteps=3000,
                  check_acceptance=False)


@pytest.mark.slow
def test_normal_dime_mixture_components():
    _test_normal(moves.DIMEMove(n_components=2))
    _test_normal(moves.DIMEMove(n_components=3), ndim=3)


@pytest.mark.slow
def test_dime_mode_hopping():
    """``test_dime.py:43-79``: two modes 16 sigma apart, a 3:1 start."""
    delta, nwalkers, ndim, nsteps = 8.0, 64, 2, 1500

    def log_prob(x):
        a = -0.5 * ((x - delta) ** 2).sum(-1)
        b = -0.5 * ((x + delta) ** 2).sum(-1)
        return torch.logaddexp(a, b)

    coords = np.random.default_rng(0).normal(size=(nwalkers, ndim)) * 0.5
    coords[: 3 * nwalkers // 4] += delta
    coords[3 * nwalkers // 4:] -= delta
    s = emcee_tpu_torch.EnsembleSampler(
        nwalkers, ndim, log_prob, vectorize=True, seed=42, device="cpu",
        moves=moves.DIMEMove(aimh_prob=0.2))
    s.run_mcmc(coords, nsteps)
    flat = s.get_chain(discard=nsteps // 2, flat=True)
    assert 0.35 < np.mean(flat[:, 0] > 0) < 0.65
    plus, minus = flat[flat[:, 0] > 0], flat[flat[:, 0] < 0]
    assert np.all(np.abs(plus.mean(axis=0) - delta) < 0.25)
    assert np.all(np.abs(minus.mean(axis=0) + delta) < 0.25)


@pytest.mark.slow
def test_dime_carry_adapts_to_target():
    nwalkers, ndim = 64, 3
    cov = np.array([[1.0, 0.5, 0.0], [0.5, 2.0, 0.3], [0.0, 0.3, 0.7]])
    icov = torch.tensor(np.linalg.inv(cov), dtype=torch.float32)

    def log_prob(x):
        return -0.5 * ((x @ icov) * x).sum(-1)

    s = emcee_tpu_torch.EnsembleSampler(nwalkers, ndim, log_prob,
                                        vectorize=True, seed=3,
                                        device="cpu", moves=moves.DIMEMove())
    s.run_mcmc(np.random.default_rng(1).normal(size=(nwalkers, ndim)), 2000)
    carry = s._move_carries[0]
    assert np.all(np.abs(carry["mean"].numpy()) < 0.3)
    assert np.all(np.abs(carry["cov"].numpy() - cov) < 0.5)
    assert float(carry["w"]) > nwalkers


@pytest.mark.slow
def test_dime_off_center_target():
    offset, nwalkers, ndim = 1.0e4, 64, 2

    def log_prob(x):
        return -0.5 * ((x - offset) ** 2).sum(-1)

    s = emcee_tpu_torch.EnsembleSampler(
        nwalkers, ndim, log_prob, vectorize=True, seed=21, device="cpu",
        moves=moves.DIMEMove(aimh_prob=1.0))
    coords = offset + np.random.default_rng(5).normal(size=(nwalkers, ndim))
    s.run_mcmc(coords, 1500)
    assert np.all(s.acceptance_fraction > 0.3)
    flat = s.get_chain(discard=500, flat=True).astype(np.float64)
    assert np.all(np.abs(flat.mean(axis=0) - offset) < 0.1)
    assert np.all(np.abs(flat.std(axis=0) - 1.0) < 0.1)
    assert np.all(np.linalg.eigvalsh(s._move_carries[0]["cov"].numpy()) > 0)
