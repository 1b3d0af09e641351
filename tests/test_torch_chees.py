"""The port's ChEES-HMC move against the JAX package.

Under JAX's own draws (the momenta and accept uniforms from the key
``ChEESHMCMove.propose`` splits, ``emcee_tpu/moves/gradient.py:468``):
``q`` (a JAX run from log-prob -inf accepts every walker), the kinetic
factors (recorded from ``Model.psum_params``), the next state, and the
carry's pending ChEES gradient ``g`` and counter ``n``, with and without
``tune``, for the identity, diagonal and full preconditioners and a
``max_leapfrog`` cap that binds.  ``tune()``'s Robbins-Monro and Adam
updates (``log_T``, ``m``, ``v``, ``k``) from equal carries; a JAX
carry after a tuned JAX run continues in the port, proposal by proposal
(``convert.carry_from_numpy``).  Tolerance rtol = atol = 1e-5, as in
``test_torch_gradient.py`` (2e-5 for the ChEES gradient, a product of
ensemble means of differences).  The van der Corput stream for n = 1 ..
10^4 exactly; the eager loop (``EagerLoops.repeat``) runs the trip count;
the statistical oracle of ``tests/integration/test_gradient_moves.py``
(``test_chees_normal``), shortened in the fast tier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import emcee_tpu
from emcee_tpu import moves as jmoves
from emcee_tpu.moves.gradient import _van_der_corput
from emcee_tpu.state import State as JState

from emcee_tpu_torch import convert, moves
from emcee_tpu_torch.chunk_graph import EagerLoops
from emcee_tpu_torch.moves.gradient import van_der_corput
from emcee_tpu_torch.state import State
from tests.test_torch_gradient import (
    COVS, ND, NW, TOL, close, jx, lp_j, model, spy, start, t)
from tests.test_torch_slice import normal_oracle


def jcarry_of(carry):
    return {k: jx(v) for k, v in carry.items()}


def port_carry(jc):
    return convert.carry_from_numpy({k: np.asarray(v) for k, v in jc.items()},
                                    device="cpu")


def chees_draws(key):
    k_mom, k_acc = jax.random.split(key)
    p0 = t(jax.random.normal(k_mom, (NW, ND), jnp.float32))
    return {"p0": p0}, t(jnp.log(jax.random.uniform(k_acc, (NW,))))


def a_carry(jmove, n=5, log_T=0.4):
    """A JAX carry part way through tuning."""
    jc = jmove.init_carry(NW, ND)
    return {**jc, "log_adj": jnp.float32(-0.2), "t": jnp.int32(4),
            "log_T": jnp.float32(log_T), "m": jnp.float32(0.05),
            "v": jnp.float32(0.01), "k": jnp.int32(3),
            "n": jnp.int32(n)}


@pytest.mark.parametrize("tune", [False, True])
@pytest.mark.parametrize("cov,max_leapfrog", [("id", 1024), ("diag", 1024),
                                              ("full", 1024), ("id", 2)])
def test_proposal_matches_jax_under_its_draws(cov, max_leapfrog, tune):
    kw = dict(trajectory_length=1.0, max_leapfrog=max_leapfrog,
              cov=COVS[cov])
    jmove, move = jmoves.ChEESHMCMove(0.3, **kw), moves.ChEESHMCMove(0.3,
                                                                    **kw)
    jc = a_carry(jmove)
    x, lp = start(1)
    key = jax.random.key(3)
    extra, log_u = chees_draws(key)
    log = []
    jq = jmove.propose(key, JState(jnp.asarray(x), jnp.full(NW, -jnp.inf)),
                       spy(log), jc)[0].coords
    want, jacc, jc2 = jmove.propose(key, JState(jnp.asarray(x),
                                                jnp.asarray(lp)),
                                    spy([]), jc, tune=tune)
    c = port_carry(jc)
    st = State(torch.from_numpy(x.copy()), torch.from_numpy(lp.copy()))
    st, acc, c = move.propose((1, 0), st, model(), c, tune=tune,
                              extra=extra, log_u=log_u)
    w = next(iter(move._work.values()))
    close(w.q, jq)
    close(0.5 * log[0], 0.5 * ((w.p0**2).sum(-1) - (w.p**2).sum(-1)))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    close(st.coords, want.coords)
    close(st.log_prob, want.log_prob)
    assert int(c["n"]) == int(jc2["n"]) == 6
    close(c["g"], jc2["g"], 2 * TOL)
    assert (float(c["g"]) != 0.0) == tune
    # The trip count the loop ran, against the JAX formula.
    u = float(_van_der_corput(jnp.int32(5)))
    eps = 0.3 * np.exp(np.float32(-0.2))
    n_steps = int(np.clip(np.ceil(u * np.exp(0.4) / eps), 1, max_leapfrog))
    assert int(w.more) + 1 == n_steps


def test_eager_loop_runs_the_trip_count():
    ran = []
    EagerLoops().repeat(("k",), lambda: ran.append(1),
                        torch.tensor(3, dtype=torch.int64))
    EagerLoops().repeat(("k",), lambda: ran.append(2),
                        torch.tensor(0, dtype=torch.int64))
    assert ran == [1, 1, 1]


def test_van_der_corput_stream_matches_jax_exactly():
    n = np.arange(1, 10_001, dtype=np.int32)
    got = van_der_corput(torch.from_numpy(n)).numpy()
    want = np.asarray(_van_der_corput(jnp.asarray(n)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got[:8], [0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875, 0.0625])


@pytest.mark.parametrize("tune_target", [0.651, None])
def test_tune_matches_jax(tune_target):
    """Robbins-Monro (with a target) and Adam on log T, three updates
    from equal carries."""
    kw = dict(tune_target=tune_target, adapt_rate=0.07)
    jmove, move = jmoves.ChEESHMCMove(0.3, **kw), moves.ChEESHMCMove(0.3,
                                                                    **kw)
    jc = a_carry(jmove)
    rng = np.random.default_rng(2)
    for g in (0.7, -0.3, 1e-3):
        acc = rng.uniform(size=NW) < 0.6
        jc = {**jc, "g": jnp.float32(g)}
        c = port_carry(jc)
        jc = jmove.tune(jc, None, jnp.asarray(acc))
        c = move.tune(c, None, torch.from_numpy(acc))
        for k in jc:
            close(c[k], jc[k])
    assert int(c["k"]) == 6


def test_jax_carry_after_tuning_continues_in_the_port():
    """A JAX sampler tunes ChEES for 30 proposals; its carry and state
    cross over (``convert``) and four tuned proposals continue in both
    packages, the JAX step each time from the port's state and carry."""
    kw = dict(trajectory_length=0.8)
    js = emcee_tpu.EnsembleSampler(
        NW, ND, lp_j, vectorize=True, seed=0,
        moves=jmoves.ChEESHMCMove(0.3, **kw))
    p0 = np.random.default_rng(3).normal(size=(NW, ND))
    js.run_mcmc(p0, 30, tune=True)
    jc = js._move_carries[0]
    assert int(jc["k"]) == 30 and float(jc["log_T"]) != np.float32(
        np.log(0.8))
    last = js.get_last_sample()
    st = State(t(np.asarray(last.coords, dtype=np.float32)),
               t(np.asarray(last.log_prob, dtype=np.float32)))
    c = port_carry(jc)
    jmove, move = jmoves.ChEESHMCMove(0.3, **kw), moves.ChEESHMCMove(0.3,
                                                                    **kw)
    for step in range(4):
        key = jax.random.key(50 + step)
        extra, log_u = chees_draws(key)
        jc = jcarry_of(c)
        want, jacc, jc = jmove.propose(
            key, JState(jx(st.coords),
                        jx(st.log_prob)), spy([]), jc,
            tune=True)
        jc = jmove.tune(jc, want, jacc)
        st, acc, c = move.propose((2, step), st, model(), c, tune=True,
                                  extra=extra, log_u=log_u)
        c = move.tune(c, st, acc)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
        close(st.coords, want.coords)
        close(st.log_prob, want.log_prob)
        for k, v in jc.items():
            close(c[k], v, 2 * TOL)


def test_carry_converts_from_jax():
    jc = jmoves.ChEESHMCMove(0.5).init_carry(8, 2)
    c = port_carry(jc)
    fresh = moves.ChEESHMCMove(0.5).init_carry(8, 2)
    assert set(c) == set(fresh)
    for k, v in c.items():
        assert v.dtype == fresh[k].dtype and torch.equal(v, fresh[k]), k
    # The step-size carry of the other gradient moves is the tuning one.
    jm = jmoves.MALAMove(0.5, tune_target=0.5).init_carry(8, 2)
    assert set(port_carry(jm)) == {"log_adj", "t"}


@pytest.mark.parametrize("nsteps", [500, pytest.param(
    2000, marks=pytest.mark.slow)])
def test_chees_normal(nsteps):
    """``test_chees_normal``: with tune off, ChEES-HMC is jittered
    fixed-T HMC, and the standard oracle holds (shortened in the fast
    tier)."""
    normal_oracle(moves.ChEESHMCMove(0.5, trajectory_length=2.0), ndim=3,
                  nsteps=nsteps, check_acceptance=False)
