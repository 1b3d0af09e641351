"""ChEES-HMC on every rung of the port's tempered ladder: K21a (the start),
K13's masked rung mode (the leapfrog trips under one read of the longest
trip count) and K21b (the tuning gradient) under ``ChEESHMCMove``'s
``propose_rungs`` (``moves/gradient.py``, ``rung_batched``), the
counterpart of the JAX package's ``jax.vmap`` of
``ChEESHMCMove.propose`` over the rungs
(``emcee_tpu/parallel/tempering.py:538``), whose ``while_loop`` runs
until the last rung is done and keeps each finished rung by a select.

Three rungs of 12 walkers in 2-D, each rung's carry its own (``log_adj``,
``log_T`` and the counter ``n``), so the rungs' trip counts differ; one
case caps ``max_leapfrog`` where it binds on one rung only.

Against the JAX package, rung by rung, under JAX's draws injected as
``extra={"p0": (T, n, d)}`` and ``log_u`` ``(T, n)``: ``q`` (a JAX run
from log-prob -inf accepts every walker), the kinetic factors (the
reduction JAX hands to ``Model.psum_params``, recorded), the acceptance,
the next state, ``n``, each rung's trip count exactly and the pending
ChEES gradient ``g`` with and without ``tune``, for the identity,
diagonal and full metrics at rtol = atol = 1e-5 (``g`` at 2e-5, as
``tests/test_torch_chees.py``); a tuned JAX ladder's carry continues in
the port (``convert.carry_from_numpy``).  Within the port: every rung at
once against each rung alone, bit for bit for the identity and diagonal
metrics (the full metric to rounding); the plain K21a, masked K13 and
K21b on the rung axis against each rung alone (a finished rung's rows
untouched); K21b's sums in the kernel's order (a numpy replay of its
threads, tree and blocks); ``PTSampler`` every rung at once against the
forced per-rung loop; and a cold-rung moment oracle.  JAX runs on the CPU
(tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu import moves as jmoves
from emcee_tpu.moves.gradient import _van_der_corput
from emcee_tpu.parallel.tempering import PTSampler as JPTSampler
from emcee_tpu.state import State as JState

from emcee_tpu_torch import PTSampler, convert, moves
from emcee_tpu_torch.chunk_graph import TemperedLogProb
from emcee_tpu_torch.model import Model, wrap_log_prob_fn
from emcee_tpu_torch.ops import chees_kernel as ck
from emcee_tpu_torch.ops import langevin_kernel as lk
from emcee_tpu_torch.ops.philox import rung_keys
from emcee_tpu_torch.state import State
from tests.test_torch_gradient import Spy, jx, lp_j, lp_t

T, NW, ND = 3, 12, 2
TOL = 1e-5  # as tests/test_torch_chees.py
BETAS = np.array([1.0, 0.5, 0.2], np.float32)
COVS = {"id": None, "diag": np.array([0.6, 1.4]),
        "full": np.array([[1.2, 0.3], [0.3, 0.7]])}


def prior_t(x):
    return -0.5 * (x**2).sum(-1) / 100.0


def prior_j(x):
    return -0.5 * jnp.sum(x**2, -1) / 100.0


def port_model(betas=BETAS):
    """The port's tempered model of every rung (a ``(T,)`` ladder), or of
    one rung (a scalar ``betas``)."""
    ll = wrap_log_prob_fn(lp_t, vectorize=True)
    lpr = wrap_log_prob_fn(prior_t, vectorize=True)
    return Model(TemperedLogProb(ll, lpr, torch.tensor(betas)), nwalkers=NW,
                 ndim=ND)


def jax_model(beta, log):
    """Rung ``beta``'s tempered JAX model (``tempering.py:379-411``),
    recording its ``psum_params`` reductions into ``log``."""

    def compute(q):
        ll, lpr = lp_j(q), prior_j(q)
        finite = lpr > -jnp.inf
        ll = jnp.where(finite, ll, 0.0)
        return jnp.where(finite, beta * ll + lpr, -jnp.inf), None

    cls = type("Spy", (Spy,), {"log": log})
    return cls(compute, nwalkers=NW, ndim=ND)


def start(seed):
    """A ladder's coordinates, tempered log-probs and the port's state
    (its blobs ``(logL, logP)``)."""
    x = np.random.default_rng(seed).normal(size=(T, NW, ND)).astype(
        np.float32)
    lp, blobs = port_model().compute_log_prob(torch.from_numpy(x))
    st = State(torch.from_numpy(x.copy()), lp.clone(),
               blobs=tuple(b.clone() for b in blobs))
    return x, lp.numpy().copy(), st


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), tol, tol)


def ladder_carry():
    """A ladder's carry part way through tuning, each rung its own: their
    trip counts at step size 1.2 are 2, 1 and 4."""
    def f(v, dt=torch.float32):
        return torch.tensor(v, dtype=dt)

    return {"log_adj": f([0.3, -0.2, 0.1]), "t": f([4, 4, 4], torch.int32),
            "log_T": f([1.0, 0.6, 2.2]), "m": f([0.05, -0.02, 0.01]),
            "v": f([0.01, 0.02, 0.005]), "k": f([3, 3, 3], torch.int32),
            "g": f([0.0, 0.0, 0.0]), "n": f([5, 6, 9], torch.int32)}


def rung_of(carry, r):
    return {k: v[r].clone() for k, v in carry.items()}


def jax_draws(key):
    """The momenta and accept uniforms' logs ChEES draws from ``key``."""
    k_mom, k_acc = jax.random.split(key)
    p0 = torch.from_numpy(np.array(
        jax.random.normal(k_mom, (NW, ND), jnp.float32)))
    log_u = torch.from_numpy(np.array(jnp.log(jax.random.uniform(
        k_acc, (NW,)))))
    return p0, log_u


def injected(keys):
    draws = [jax_draws(k) for k in keys]
    return ({"p0": torch.stack([d[0] for d in draws])},
            torch.stack([d[1] for d in draws]))


def jax_steps(jmove, jc, max_leapfrog):
    """The JAX formula's trip count of carry ``jc``."""
    u = _van_der_corput(jc["n"])
    eps = jmove._eps(jc, jnp.float32)
    return int(jnp.clip(jnp.ceil(u * jnp.exp(jc["log_T"]) / eps), 1.0,
                        float(max_leapfrog)).astype(jnp.int32))


# -- against the JAX package, rung by rung --------------------------------

CASES = [("id", 1024, False), ("id", 1024, True), ("diag", 1024, True),
         ("full", 1024, False), ("full", 1024, True), ("id", 3, True)]
STEP = 1.2


@pytest.mark.parametrize("cov,max_leapfrog,tune", CASES)
def test_propose_rungs_matches_jax_rung_by_rung(cov, max_leapfrog, tune):
    """Each rung's q, kinetic factors, acceptance, next state, counter,
    trip count and ChEES gradient against its JAX move at ``beta[r]``
    under its own key and carry."""
    kw = dict(trajectory_length=1.0, max_leapfrog=max_leapfrog,
              cov=COVS[cov])
    jmove, move = (jmoves.ChEESHMCMove(STEP, **kw),
                   moves.ChEESHMCMove(STEP, **kw))
    carry = ladder_carry()
    jcs = [{k: jx(v[r]) for k, v in carry.items()} for r in range(T)]
    keys = [jax.random.key(40 + r) for r in range(T)]
    extra, log_u = injected(keys)
    x, lp, st = start(1)
    st, acc, carry = move.propose_rungs((rung_keys(5, T, "cpu"), 0), st,
                                        port_model(), carry, tune=tune,
                                        extra=extra, log_u=log_u)
    w = move.work(st.coords)
    steps = []
    for r in range(T):
        log = []
        jq = jmove.propose(keys[r], JState(jnp.asarray(x[r]),
                                           jnp.full(NW, -jnp.inf)),
                           jax_model(BETAS[r], log), jcs[r])[0].coords
        close(w.q[r], jq)
        close(0.5 * log[0], 0.5 * ((w.p0[r]**2).sum(-1)
                                   - (w.p[r]**2).sum(-1)))
        want, jacc, jc2 = jmove.propose(
            keys[r], JState(jnp.asarray(x[r]), jnp.asarray(lp[r])),
            jax_model(BETAS[r], []), jcs[r], tune=tune)
        np.testing.assert_array_equal(acc[r].numpy(), np.asarray(jacc))
        close(st.coords[r], want.coords)
        close(st.log_prob[r], want.log_prob)
        assert int(carry["n"][r]) == int(jc2["n"]) == int(jcs[r]["n"]) + 1
        close(carry["g"][r], jc2["g"], 2 * TOL)
        steps.append(jax_steps(jmove, jcs[r], max_leapfrog))
        assert int(w.more[r]) + 1 == steps[-1], r
    assert len(set(steps)) == T  # every rung its own trip count
    assert int(w.start.top) == max(steps) - 1
    assert bool((carry["g"] != 0).all()) == tune
    if max_leapfrog == 3:  # it binds on rung 2 alone (4 steps unclipped)
        assert steps == [2, 1, 3]
    assert 0 < int(acc.sum()) < T * NW


def test_jax_ladder_carry_after_tuning_continues_in_the_port():
    """A JAX ``PTSampler`` tunes ChEES for 20 proposals; its ``(T,)``
    carry and last state cross over (``convert``) and three tuned
    proposals continue in both packages, JAX rung by rung from the port's
    state and carry each time."""
    kw = dict(trajectory_length=0.8)
    jpt = JPTSampler(T, NW, ND, lp_j, prior_j, seed=0,
                     moves=jmoves.ChEESHMCMove(0.3, **kw))
    jpt.run_mcmc(np.random.default_rng(3).normal(size=(T, NW, ND)).astype(
        np.float32), 20, tune=True)
    jc = jpt._move_carries[0]
    assert np.all(np.asarray(jc["k"]) == 20)
    assert len(set(np.asarray(jc["log_T"]).tolist())) == T
    betas = np.asarray(jpt.betas, dtype=np.float32)
    c = convert.carry_from_numpy({k: np.asarray(v) for k, v in jc.items()},
                                 device="cpu")
    assert c["log_T"].shape == (T,) and c["n"].dtype == torch.int32
    x = torch.from_numpy(np.asarray(jpt.get_chain()[-1], dtype=np.float32))
    model = port_model(betas)
    lp, blobs = model.compute_log_prob(x)
    st = State(x.clone(), lp.clone(), blobs=tuple(b.clone() for b in blobs))
    jmove, move = (jmoves.ChEESHMCMove(0.3, **kw),
                   moves.ChEESHMCMove(0.3, **kw))
    for step in range(3):
        keys = [jax.random.key(60 + 3 * step + r) for r in range(T)]
        extra, log_u = injected(keys)
        jcs = [{k: jx(v[r]) for k, v in c.items()} for r in range(T)]
        wants = []
        for r in range(T):
            want, jacc, jc2 = jmove.propose(
                keys[r], JState(jx(st.coords[r]), jx(st.log_prob[r])),
                jax_model(betas[r], []), jcs[r], tune=True)
            wants.append((want, jacc, jmove.tune(jc2, want, jacc)))
        st, acc, c = move.propose_rungs((rung_keys(2, T, "cpu"), step), st,
                                        model, c, tune=True, extra=extra,
                                        log_u=log_u)
        c = move.tune(c, st, acc, model)
        for r, (want, jacc, jc2) in enumerate(wants):
            np.testing.assert_array_equal(acc[r].numpy(), np.asarray(jacc))
            close(st.coords[r], want.coords)
            close(st.log_prob[r], want.log_prob)
            for k, v in jc2.items():
                close(c[k][r], v, 2 * TOL)
    assert torch.all(c["k"] == 23)


# -- every rung at once against each rung alone, within the port ----------

@pytest.mark.parametrize("tune", [False, True])
@pytest.mark.parametrize("cov", ["id", "diag", "full"])
def test_propose_rungs_equals_each_rung_alone(cov, tune):
    """``propose_rungs`` under the rungs' keys against ``propose`` of each
    rung under its own key, the draws from the stream, with
    ``max_leapfrog`` binding on one rung: the state, its blobs, the
    acceptance, the counts and every carry entry, bit for bit for the
    identity and diagonal metrics, to rounding for the full one."""
    move = moves.ChEESHMCMove(STEP, cov=COVS[cov], max_leapfrog=3)
    carry = ladder_carry()
    rung_carries = [rung_of(carry, r) for r in range(T)]
    keys = rung_keys(21, T, "cpu")
    _, _, st = start(5)
    rungs = [State(st.coords[r].clone(), st.log_prob[r].clone(),
                   blobs=tuple(b[r].clone() for b in st.blobs))
             for r in range(T)]
    count = torch.zeros((T, NW), dtype=torch.int32)
    st, acc, carry = move.propose_rungs((keys, 4), st, port_model(), carry,
                                        count, tune=tune)
    same = (lambda a, b: torch.equal(a, b)) if cov != "full" else (
        lambda a, b: close(a, b) or True)
    for r in range(T):
        cr = torch.zeros(NW, dtype=torch.int32)
        sr, ar, c_r = move.propose((keys.seeds[r], 4), rungs[r],
                                   port_model(BETAS[r]), rung_carries[r],
                                   cr, tune=tune)
        assert torch.equal(ar, acc[r]) and torch.equal(cr, count[r]), r
        assert same(sr.coords, st.coords[r]), r
        assert same(sr.log_prob, st.log_prob[r]), r
        assert all(same(a, b[r]) for a, b in zip(sr.blobs, st.blobs)), r
        for k, v in c_r.items():
            assert same(v, carry[k][r]), (r, k)
    assert 0 < int(acc.sum()) < T * NW
    assert move.work(st.coords).more.tolist() == [1, 0, 2]


def test_k21a_plain_rung_axis_equals_each_rung_alone():
    """K21a's plain version on the rung axis against each rung's ``()``
    carry alone: eps, u, T, the trips after the first; the largest into
    ``top``, ``trip`` zeroed; a huge T clamps at ``max_leapfrog``, the
    counter's wrap and n = 2^31 - 1 keep the 32-bit reversal."""
    log_adj = torch.tensor([0.3, -0.2, 0.1, 10.0, -10.0])
    log_T = torch.tensor([0.4, -0.3, 1.2, 15.0, -15.0])
    n = torch.tensor([5, 6, 9, 2**31 - 1, -7], dtype=torch.int32)
    out = ck.start_out((5,), "cpu")
    out.trip.fill_(7)
    ck.chees_start(log_adj, log_T, n, 0.3, 50, out)
    assert int(out.trip) == 0 and int(out.top) == int(out.more.max())
    for r in range(5):
        one = ck.start_out((), "cpu")
        ck.chees_start(log_adj[r], log_T[r], n[r], 0.3, 50, one)
        for a, b in zip(one[:4], out[:4]):
            assert torch.equal(a, b[r]), r
        assert int(one.top) == int(one.more)
    assert int(out.more[4]) == 0  # T = e^-15: one step
    # The van der Corput values against the JAX package's, exactly.
    np.testing.assert_array_equal(
        out.u.numpy(), np.asarray(_van_der_corput(jnp.asarray(n.numpy()))))


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("diag", [False, True])
def test_k13_masked_plain_equals_each_rung_alone(diag, full):
    """K13's masked rung mode over ``max(more)`` trips against each rung
    stepping ``more[r]`` times alone: every rung's p and q bit for bit, a
    rung with no trips untouched, the trip word advanced once a trip
    (a full metric's two launches, kicks then drift, advance once)."""
    gen = torch.Generator().manual_seed(3 * diag + full)
    nt, n, nd = 3, 5, 4
    x, p = (torch.randn(nt, n, nd, generator=gen) for _ in range(2))
    gs = [torch.randn(nt, n, nd, generator=gen) for _ in range(4)]
    eps = 0.3 + torch.rand(nt, generator=gen)
    d = (0.5 + torch.rand(nd, generator=gen)) if diag else None
    more = torch.tensor([0, 2, 4])
    trip = torch.zeros((), dtype=torch.int64)
    mask = lk.trip_mask(more, trip)
    xb, pb = x.clone(), p.clone()
    for k in range(int(more.max())):
        if full:
            lk.leapfrog_plain(pb, gs[k], eps, d=d, kicks=2, mask=mask,
                              advance=False)
            lk.leapfrog_plain(pb, None, eps, d=d, kicks=0, x=xb, mask=mask)
        else:
            lk.leapfrog_plain(pb, gs[k], eps, d=d, kicks=2, x=xb, mask=mask)
        assert int(trip) == k + 1
    for r in range(nt):
        xr, pr = x[r].clone(), p[r].clone()
        for k in range(int(more[r])):
            if full:
                lk.leapfrog_plain(pr, gs[k][r], eps[r], d=d, kicks=2)
                lk.leapfrog_plain(pr, None, eps[r], d=d, kicks=0, x=xr)
            else:
                lk.leapfrog_plain(pr, gs[k][r], eps[r], d=d, kicks=2, x=xr)
        assert torch.equal(xr, xb[r]) and torch.equal(pr, pb[r]), r
    assert torch.equal(xb[0], x[0]) and torch.equal(pb[0], p[0])
    assert not torch.equal(xb[2], x[2])


def k21b_inputs(gen, nt, n, nd, bad=True):
    x, q, p = (torch.randn(nt, n, nd, generator=gen) for _ in range(3))
    lp, lp_q = (torch.randn(nt, n, generator=gen) for _ in range(2))
    kinetic = 0.3 * torch.randn(nt, n, generator=gen)
    if bad:  # a NaN, an infinite and a large lnpdiff
        lp_q[0, 1] = float("nan")
        lp_q[-1, 2] = float("inf")
        lp[-1, 3] = float("-inf")
        kinetic[0, 4] = 50.0
    u = torch.rand(nt, generator=gen)
    traj = 0.5 + torch.rand(nt, generator=gen)
    return x, q, p, lp, lp_q, kinetic, u, traj


METRICS = ("id", "diag", "full")


def metric_args(kind, nd, gen):
    if kind == "diag":
        return dict(d=0.5 + torch.rand(nd, generator=gen))
    if kind == "full":
        a = torch.randn(nd, nd, generator=gen)
        return dict(L=torch.linalg.cholesky(a @ a.T + nd * torch.eye(nd)))
    return {}


@pytest.mark.parametrize("rows", [None, 256])
@pytest.mark.parametrize("kind", METRICS)
def test_k21b_plain_rung_axis_equals_each_rung_alone(kind, rows):
    """K21b's plain version on the rung axis against each rung alone, bit
    for bit, one block a rung and in blocks of 256 rows (600 walkers),
    with a NaN, an infinite and a large ``lnpdiff``."""
    gen = torch.Generator().manual_seed(METRICS.index(kind) + 7)
    nt, n, nd = 3, 600, 5
    args = k21b_inputs(gen, nt, n, nd)
    kw = metric_args(kind, nd, gen)
    plan = ck.grad_plan(n, rows)
    assert plan.blocks == (1 if rows is None else 3)
    g = torch.zeros(nt)
    ck.chees_gradient_plain(*args, g, plan=plan, **kw)
    assert torch.all(torch.isfinite(g)) and torch.all(g != 0)
    for r in range(nt):
        gr = torch.zeros(())
        ck.chees_gradient_plain(*(a[r] for a in args), gr, plan=plan, **kw)
        assert torch.equal(gr, g[r]), r
    # Against the JAX formula's plain sums (the port's former chain).
    x, q, p, lp, lp_q, kin, u, traj = (a.double() for a in args)
    lpm = p if kind == "id" else (p * kw["d"].double() if kind == "diag"
                                  else p @ kw["L"].double().T)
    alpha = torch.exp(torch.clamp((lp_q - lp) + kin, max=0.0))
    alpha = torch.where(torch.isfinite(alpha), alpha, 0.0)
    dq, dx = q - q.mean(1, keepdim=True), x - x.mean(1, keepdim=True)
    delta = (dq * dq).sum(-1) - (dx * dx).sum(-1)
    pw = 0.5 * delta * (2.0 * u[:, None] * (dq * lpm).sum(-1))
    want = traj * (alpha * pw).mean(1) / (alpha.mean(1) + 1e-12)
    close(g, want, 2 * TOL)


@pytest.mark.parametrize("n,rows", [(1, None), (255, None), (257, None),
                                    (600, 256), (2049, None), (3000, 512)])
def test_k21b_sums_follow_the_kernels_loops(n, rows):
    """``_block_sums`` against a numpy float32 replay of K21b's loops
    (``csrc/chees.cu``): thread t of block b sums rows b*rows + t + m*256
    from +0.0, the block's partials meet in the tree (at level s, t += t +
    s), the blocks' sums are added in order from +0.0; bit for bit."""
    rng = np.random.default_rng(n)
    v = rng.normal(size=(2, n, 3)).astype(np.float32) * np.float32(1e3)
    plan = ck.grad_plan(n, rows)
    got = ck._block_sums(torch.from_numpy(v), plan).numpy()
    B = plan.threads
    want = np.zeros((2, 3), np.float32)
    for b in range(plan.blocks):
        part = np.zeros((2, B, 3), np.float32)
        for t in range(B):
            for i in range(b * plan.rows + t, min((b + 1) * plan.rows, n), B):
                part[:, t] = part[:, t] + v[:, i]
        s = B
        while s > 1:
            s //= 2
            part[:, :s] = part[:, :s] + part[:, s:2 * s]
        want = want + part[:, 0]
    np.testing.assert_array_equal(got, want)


# -- PTSampler: every rung at once against the forced per-rung loop --------

def lp_box(x):
    return torch.where(torch.all(torch.abs(x) < 4.0), 0.0, -torch.inf)


def ll_blobs(x):
    ll = -0.5 * torch.sum((x - 1.0) ** 2)
    return ll, 2.0 * ll, x


@pytest.mark.parametrize("make", [
    lambda: moves.ChEESHMCMove(0.4, max_leapfrog=3),
    lambda: moves.ChEESHMCMove(0.3, cov=np.array([0.5, 1.5]),
                               trajectory_length=0.7)])
def test_batched_path_equals_the_per_rung_loop(make):
    """Every rung at once against the forced per-rung loop, tuning then
    not: chain, logL, logP, the blobs ``(2 logL, x)``, acceptance, swaps,
    random state and every carry entry, bit for bit."""
    ends = []
    for batched in (True, False):
        s = PTSampler(3, 16, 2, ll_blobs, lp_box, moves=make(), seed=11,
                      device="cpu")
        s._batched = batched
        p0 = np.random.default_rng(2).normal(size=(3, 16, 2))
        s.run_mcmc(p0, 4, thin_by=2, tune=True)
        s.run_mcmc(None, 3)
        assert s._program.batched is batched
        blobs = s.get_blobs()
        ends.append((s.get_chain(), s.get_log_like(), s.get_log_prior(),
                     np.asarray(blobs[0]), np.asarray(blobs[1]),
                     s.backend.accepted, s.swaps_accepted,
                     s.backend.random_state,
                     {k: v.clone() for k, v in s._move_carries[0].items()}))
    for x, y in zip(ends[0][:8], ends[1][:8]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    a, b = ends[0][8], ends[1][8]
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.all(a["k"] == 8) and torch.all(a["n"] == 12)
    assert len(set(a["log_T"].tolist())) == 3
    assert 0 < ends[0][5].sum() < 11 * 3 * 16


def test_cold_rung_moments_under_tempered_chees():
    """ChEES-HMC on every rung at once, tuned then frozen: the cold rung
    of a 2-D unit Gaussian likelihood under a wide prior has mean ~0 and
    variance ~1 (the prior's pull, 1 / (1 + 1/100), is within the
    window)."""
    steps = 600
    s = PTSampler(4, 32, 2, lambda x: -0.5 * torch.sum(x**2),
                  lambda x: -0.5 * torch.sum(x**2) / 100.0, seed=3,
                  device="cpu", moves=moves.ChEESHMCMove(0.5))
    p0 = np.random.default_rng(7).normal(size=(4, 32, 2))
    s.run_mcmc(p0, 100, tune=True, store=False)
    s.run_mcmc(None, steps)
    assert s._program.batched
    cold = s.get_chain(temp=0, flat=True, discard=steps // 5)
    assert np.all(np.abs(cold.mean(axis=0)) < 0.1), cold.mean(axis=0)
    assert np.all(np.abs(cold.var(axis=0) - 1.0) < 0.15), cold.var(axis=0)
    assert np.all(s.acceptance_fraction > 0.3)
    assert np.all(s.tswap_acceptance_fraction > 0)
