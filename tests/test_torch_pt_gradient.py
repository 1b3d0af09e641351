"""The gradient moves on every rung of the port's tempered ladder: K11, K12
and K13 with the rung axis (``emcee_tpu_torch/ops/langevin_kernel.py``)
under ``MALAMove``, ``HMCMove``, ``EnsembleMALAMove`` and
``EnsembleHMCMove`` (``moves/gradient.py``, ``rung_batched``), the
counterpart of the JAX package's ``jax.vmap`` of the move over the rungs
(``emcee_tpu/parallel/tempering.py:532-541``, each rung's model
``_tempered_model(beta)``, ``:379``).

Against the JAX package, rung by rung: each rung's JAX move runs under
its tempered model at ``beta[r]`` and its own key, whose draws are
reproduced (``tests/test_torch_gradient.py`` ``jax_draws`` /
``ensemble_draws``) and injected into the port as ``(T, ...)`` rows; the
proposal, the factors (the reductions the JAX move hands to
``psum_params``, recorded) and the next state agree at rtol = atol = 1e-5,
the tolerance of ``test_torch_gradient.py``.  Exact within the port, bit
for bit: the plain versions of K11 (draws, MALA with the identity and a
diagonal, injected ``z``, the ``(T,)`` jitter), K12 (both modes) and K13
(0, 1 and 2 kicks, with and without the drift) on the rung axis against
the one-ensemble plain versions under ``keys.seeds[r]``, at an int offset
and at a device offset word; ``PTSampler`` with each move proposing every
rung at once against the forced per-rung loop (the private ``_batched``
switch), with user blobs, tuning and a mixture with ``StretchMove()``.
The ensemble moves' per-rung products by ``L`` are one batched matmul
there, which on the CPU rounds otherwise than the rung's own ``mm``
(``ROADMAP.md`` section 3): their batched path is held to the loop at
rtol = atol = 1e-5 with the same acceptance and swaps.  JAX runs on the
CPU (tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu import moves as jmoves
from emcee_tpu.state import State as JState

from emcee_tpu_torch import PTSampler, moves
from emcee_tpu_torch.chunk_graph import TemperedLogProb
from emcee_tpu_torch.model import Model, wrap_log_prob_fn
from emcee_tpu_torch.moves import gradient
from emcee_tpu_torch.moves.gradient import batch_grad, batch_value_and_grad
from emcee_tpu_torch.ops import langevin_kernel as lk
from emcee_tpu_torch.ops.philox import DeviceOffset, rung_keys
from emcee_tpu_torch.state import State
from tests.test_torch_gradient import (
    COVS, ND, Spy, ensemble_draws, jax_draws, lp_j, lp_t)

TOL = 1e-5  # as tests/test_torch_gradient.py
T, NW = 3, 16
BETAS = np.array([1.0, 0.55, 0.2], np.float32)


def prior_t(x):
    return -0.5 * (x**2).sum(-1) / 100.0


def prior_j(x):
    return -0.5 * jnp.sum(x**2, -1) / 100.0


def port_model(betas=BETAS, nw=NW):
    """The port's tempered model of every rung (a ``(T,)`` ladder), or of
    one rung (a scalar ``betas``)."""
    ll = wrap_log_prob_fn(lp_t, vectorize=True)
    lpr = wrap_log_prob_fn(prior_t, vectorize=True)
    return Model(TemperedLogProb(ll, lpr, torch.tensor(betas)), nwalkers=nw,
                 ndim=ND)


def jax_model(beta, log, nw=NW):
    """Rung ``beta``'s tempered JAX model (``tempering.py:379-411``),
    recording its ``psum_params`` reductions into ``log``."""

    def compute(q):
        ll, lpr = lp_j(q), prior_j(q)
        finite = lpr > -jnp.inf
        ll = jnp.where(finite, ll, 0.0)
        return jnp.where(finite, beta * ll + lpr, -jnp.inf), None

    cls = type("Spy", (Spy,), {"log": log})
    return cls(compute, nwalkers=nw, ndim=ND)


def start(seed, nw=NW):
    """A ladder's coordinates, tempered log-probs and the port's state
    (its blobs ``(logL, logP)``)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, nw, ND)).astype(np.float32)
    lp, blobs = port_model(nw=nw).compute_log_prob(torch.from_numpy(x))
    st = State(torch.from_numpy(x.copy()), lp.clone(),
               blobs=tuple(b.clone() for b in blobs))
    return x, lp.numpy().copy(), st


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), tol, tol)


def stack(draws):
    """One ``(T, ...)`` tensor of each entry of the rungs' draws."""
    return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}


def make(kind, cov, jitter, tune_target=None):
    kw = dict(cov=COVS[cov], tune_target=tune_target)
    if kind == "mala":
        return jmoves.MALAMove(1.3, **kw), moves.MALAMove(1.3, **kw)
    kw.update(n_leapfrog=3, jitter=jitter)
    return jmoves.HMCMove(0.4, **kw), moves.HMCMove(0.4, **kw)


LOG_ADJ = np.array([0.3, -0.2, 0.1], np.float32)
#: HMC's eager JAX scans compile at every call (~2 s a case): half of its
#: metric x jitter cases run in the slow tier
MOVES = ([("mala", c, 0.0) for c in ("id", "diag", "full")]
         + [("hmc", c, j) if (c == "diag") == (j == 0.0)
            else pytest.param("hmc", c, j, marks=pytest.mark.slow)
            for c in ("id", "diag", "full") for j in (0.0, 0.2)])


@pytest.mark.parametrize("kind,cov,jitter", MOVES)
def test_whole_ensemble_moves_match_jax_rung_by_rung(kind, cov, jitter):
    """Each rung's q, factors and next state against its JAX move at
    ``beta[r]`` under its own key; the tuned scale differs by rung."""
    tuned = cov != "id"
    jmove, move = make(kind, cov, jitter, 0.5 if tuned else None)
    carry = move.init_carry(NW, ND, device="cpu")
    if tuned:
        carry = {"log_adj": torch.tensor(LOG_ADJ),
                 "t": torch.full((T,), 3, dtype=torch.int32)}
    keys = [jax.random.key(50 + r) for r in range(T)]
    draws = [jax_draws(k, kind, jitter, nw=NW) for k in keys]
    extra = stack([d[0] for d in draws])
    log_u = torch.stack([d[1] for d in draws])
    x, lp, st = start(1)
    xt, m = torch.from_numpy(x), port_model()
    # q and the factors, through the port's chain on the rung axis.
    eps = move._eps(carry, xt)
    metric = move._metric(ND, xt.device)
    vag = batch_value_and_grad(m)
    if kind == "mala":
        q, f, _, _ = gradient._mala(xt, batch_grad(m)(xt), eps, metric, vag,
                                    (rung_keys(0, T, "cpu"), 0), extra["z"])
    else:
        if jitter:
            eps = gradient._jittered(eps, jitter, extra["v"])
        q, f, _, _ = gradient._hmc(xt, eps, metric, batch_grad(m), vag,
                                   extra["p0"], move.n_leapfrog)
    assert q.shape == (T, NW, ND) and f.shape == (T, NW)
    # The next state, every rung at once.
    st, acc, _ = move.propose_rungs((rung_keys(5, T, "cpu"), 0), st, m,
                                    carry, extra=extra, log_u=log_u)
    for r in range(T):
        jc = ({k: jnp.asarray(v[r].numpy()) for k, v in carry.items()}
              if tuned else ())
        log = []
        jq = jmove.propose(keys[r], JState(jnp.asarray(x[r]),
                                           jnp.full(NW, -jnp.inf)),
                           jax_model(BETAS[r], log), jc)[0].coords
        close(q[r], jq)
        if kind == "hmc":
            close(f[r], 0.5 * log[0])
        else:
            e = jmove._eps(jc, jnp.float32)
            close(f[r], (log[0] - log[1] / e**2) / 2.0)
        want, jacc, _ = jmove.propose(
            keys[r], JState(jnp.asarray(x[r]), jnp.asarray(lp[r])),
            jax_model(BETAS[r], []), jc)
        np.testing.assert_array_equal(acc[r].numpy(), np.asarray(jacc))
        close(st.coords[r], want.coords)
        close(st.log_prob[r], want.log_prob)
    assert 0 < int(acc.sum()) < T * NW


def ensemble_pair(cls, n, jitter, **kw):
    if cls == "mala":
        return (jmoves.EnsembleMALAMove(0.9, **kw),
                moves.EnsembleMALAMove(0.9, **kw))
    kw.update(n_leapfrog=n, jitter=jitter)
    return (jmoves.EnsembleHMCMove(0.4, **kw),
            moves.EnsembleHMCMove(0.4, **kw))


ENSEMBLE = [("mala", 1, 0.0), ("hmc", 1, 0.0), ("hmc", 3, 0.2)]
SCALE = np.array([1.2, 0.8, 1.0], np.float32)


@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("cls,n,jitter", ENSEMBLE)
def test_ensemble_proposal_matches_jax_rung_by_rung(cls, n, jitter, split):
    """Each rung's group proposal against JAX's ``get_proposal`` at
    ``beta[r]``: the rung's own complement metric, scale and key."""
    jmove, move = ensemble_pair(cls, n, jitter)
    x, _, _ = start(3)
    ng = NW // 2
    keys = [jax.random.key(20 + 3 * r + split) for r in range(T)]
    q, f = move.get_proposal(
        (rung_keys(1, T, "cpu"), 2), torch.from_numpy(x), split,
        port_model(),
        extra=stack([ensemble_draws(k, cls, jitter, ng) for k in keys]),
        scale=torch.from_numpy(SCALE))
    assert q.shape == (T, ng, ND) and f.shape == (T, ng)
    for r in range(T):
        s = x[r, split * ng:(split + 1) * ng]
        c = x[r, (1 - split) * ng:(2 - split) * ng]
        jq, jf = jmove.get_proposal(keys[r], jnp.asarray(s), (c,),
                                    jax_model(BETAS[r], []),
                                    scale=jnp.float32(SCALE[r]))
        close(q[r], jq)
        close(f[r], jf)


@pytest.mark.parametrize("cls,n,jitter", [
    ("mala", 1, 0.0), pytest.param("hmc", 3, 0.2, marks=pytest.mark.slow)])
def test_ensemble_next_state_matches_jax_rung_by_rung(cls, n, jitter):
    """Both splits of the blocked engine on every rung at once under each
    rung's JAX split keys and accept uniforms, three proposals, each JAX
    step from the port's state."""
    jmove, move = ensemble_pair(cls, n, jitter, randomize_split=False)
    _, _, st = start(4)
    ng = NW // 2
    m = port_model()
    for step in range(3):
        ks = [jax.random.split(jax.random.key(30 + 7 * step + r), 3)
              for r in range(T)]
        log_acc_u = [jnp.log(jax.random.uniform(k[0], (2, ng))) for k in ks]
        wants = [jmove._propose_blocked(
            k[1:], log_acc_u[r], None,
            JState(jnp.array(st.coords[r].numpy(), copy=True),
                   jnp.array(st.log_prob[r].numpy(), copy=True)),
            jax_model(BETAS[r], []), (), ng) for r, k in enumerate(ks)]
        st, acc, _ = move._propose_blocked(
            (rung_keys(6, T, "cpu"), step), st, m, (), ng,
            log_acc_u=torch.from_numpy(
                np.stack([np.asarray(u) for u in log_acc_u], 1)),
            extra_u=[stack([ensemble_draws(k[1 + j], cls, jitter, ng)
                            for k in ks]) for j in range(2)])
        for r, (want, jacc, _) in enumerate(wants):
            np.testing.assert_array_equal(acc[r].numpy(), np.asarray(jacc))
            close(st.coords[r], want.coords)
            close(st.log_prob[r], want.log_prob)


# -- every rung at once against each rung alone, within the port ----------

@pytest.mark.parametrize("kind,cov,jitter", [
    ("mala", "id", 0.0), ("mala", "full", 0.0), ("hmc", "scalar", 0.2),
    ("hmc", "full", 0.2)])
def test_propose_rungs_equals_each_rung_alone(kind, cov, jitter):
    """``propose_rungs`` under the rungs' keys against ``propose`` of each
    rung under its own key, the draws from the stream, bit for bit: the
    state, its blobs, the acceptance and the counts (a full metric's
    product by ``L`` folds every rung's rows into one matmul, which on the
    CPU rounds as each rung's own)."""
    _, move = make(kind, cov, jitter, 0.5)
    carry = {"log_adj": torch.tensor(LOG_ADJ),
             "t": torch.full((T,), 3, dtype=torch.int32)}
    keys = rung_keys(21, T, "cpu")
    _, _, st = start(5)
    rungs = [State(st.coords[r].clone(), st.log_prob[r].clone(),
                   blobs=tuple(b[r].clone() for b in st.blobs))
             for r in range(T)]
    count = torch.zeros((T, NW), dtype=torch.int32)
    st, acc, _ = move.propose_rungs((keys, 4), st, port_model(), carry,
                                    count)
    for r in range(T):
        one = {k: v[r] for k, v in carry.items()}
        cr = torch.zeros(NW, dtype=torch.int32)
        sr, ar, _ = move.propose((keys.seeds[r], 4), rungs[r],
                                 port_model(BETAS[r]), one, cr)
        assert torch.equal(ar, acc[r]) and torch.equal(cr, count[r])
        assert torch.equal(sr.coords, st.coords[r])
        assert torch.equal(sr.log_prob, st.log_prob[r])
        assert all(torch.equal(a, b[r]) for a, b in zip(sr.blobs, st.blobs))
    assert 0 < int(acc.sum()) < T * NW


@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("cls,n,jitter", ENSEMBLE)
def test_ensemble_rung_axis_against_each_rung_alone(cls, n, jitter, split):
    """An ensemble move's proposal of every rung at once (one batched
    product and Cholesky of the rungs' complement covariances) against
    each rung's own under its own key, the draws from the stream: rtol =
    atol = 1e-5 (the batched products round otherwise than each rung's
    own, ``ROADMAP.md`` section 3)."""
    _, move = ensemble_pair(cls, n, jitter)
    keys = rung_keys(8, T, "cpu")
    x = torch.from_numpy(start(6)[0])
    scale = torch.from_numpy(SCALE)
    q, f = move.get_proposal((keys, 11), x, split, port_model(),
                             scale=scale)
    for r in range(T):
        qr, fr = move.get_proposal((keys.seeds[r], 11), x[r], split,
                                   port_model(BETAS[r]), scale=scale[r])
        close(qr, q[r])
        close(fr, f[r])


# -- the rung axis of the plain versions against one ensemble, bit for bit --

def offsets(kind):
    """``(rung-axis offset, the same as an int)``."""
    if kind == "device word":
        return DeviceOffset(torch.tensor(5, dtype=torch.int64), 4), 9
    return 9, 9


def equal(a, b):
    return (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("offset_kind", ["int", "device word"])
@pytest.mark.parametrize("mode", ["draw", "draw and v", "v alone",
                                  "mala", "mala diag", "mala z given",
                                  "mala diag z given"])
def test_k11_plain_rung_axis_equals_each_rung_alone(mode, offset_kind):
    gen = torch.Generator().manual_seed(hash(mode) % 2**31)
    nt, n, nd = 4, 7, 3
    keys = rung_keys(77, nt, "cpu")
    off, off_int = offsets(offset_kind)
    x, g, z = (torch.randn(nt, n, nd, generator=gen) for _ in range(3))
    eps = 0.3 + torch.rand(nt, generator=gen)
    d = 0.5 + torch.rand(nd, generator=gen)
    kw = dict(row0=5)
    if mode.startswith("mala"):
        kw.update(x=x, g=g, eps=eps)
    if "diag" in mode:
        kw["d"] = d
    if "given" in mode or mode == "v alone":
        kw["z"] = z
    v = torch.empty(nt) if "v" in mode.split() else None
    zz, qq = lk.langevin_step_plain((nt, n, nd), "cpu", seed=keys,
                                    offset=off, v=v, v_split=1, **kw)
    assert zz.shape == (nt, n, nd)
    for r in range(nt):
        one = {k: (t[r] if k in ("x", "g", "z", "eps") else t)
               for k, t in kw.items()}
        vr = torch.empty(()) if v is not None else None
        zr, qr = lk.langevin_step_plain((n, nd), "cpu", seed=keys.seeds[r],
                                        offset=off_int, v=vr, v_split=1,
                                        **one)
        assert torch.equal(zr, zz[r]) and equal(qr, None if qq is None
                                                 else qq[r]), r
        if v is not None:
            assert torch.equal(vr, v[r]), r
    if "z" not in kw:  # the rungs draw apart
        assert not torch.equal(zz[0], zz[1])
    if v is not None:
        assert len(set(v.tolist())) == nt


@pytest.mark.parametrize("mode", ["kinetic", "mala", "mala c", "mala c d"])
def test_k12_plain_rung_axis_equals_each_rung_alone(mode):
    gen = torch.Generator().manual_seed(len(mode))
    nt, n, nd = 3, 9, 5
    a, b, c = (torch.randn(nt, n, nd, generator=gen) for _ in range(3))
    eps = 0.3 + torch.rand(nt, generator=gen)
    d = 0.5 + torch.rand(nd, generator=gen)
    kw = {}
    if mode != "kinetic":
        kw["eps"] = eps
    if "d" in mode.split():
        kw["d"] = d
    cc = c if "c" in mode.split() else None
    f = lk.langevin_factor_plain(a, b, cc, **kw)
    assert f.shape == (nt, n)
    for r in range(nt):
        one = dict(kw, eps=eps[r]) if "eps" in kw else kw
        fr = lk.langevin_factor_plain(a[r], b[r], None if cc is None
                                      else cc[r], **one)
        assert torch.equal(fr, f[r]), r


@pytest.mark.parametrize("kicks,drift", [(0, True), (1, False), (1, True),
                                         (2, False), (2, True)])
@pytest.mark.parametrize("diag", [False, True])
def test_k13_plain_rung_axis_equals_each_rung_alone(kicks, drift, diag):
    gen = torch.Generator().manual_seed(10 * kicks + drift + 2 * diag)
    nt, n, nd = 3, 6, 4
    x, p, g = (torch.randn(nt, n, nd, generator=gen) for _ in range(3))
    eps = 0.3 + torch.rand(nt, generator=gen)
    d = (0.5 + torch.rand(nd, generator=gen)) if diag else None
    xb, pb = x.clone(), p.clone()
    lk.leapfrog_plain(pb, g, eps, d=d, kicks=kicks,
                      x=xb if drift else None)
    for r in range(nt):
        xr, pr = x[r].clone(), p[r].clone()
        lk.leapfrog_plain(pr, g[r], eps[r], d=d, kicks=kicks,
                          x=xr if drift else None)
        assert torch.equal(xr, xb[r]) and torch.equal(pr, pb[r]), r
    assert not torch.equal(xb, x) if drift else torch.equal(xb, x)


# -- PTSampler: every rung at once against the forced per-rung loop --------

def ll_blobs(x):  # tests/unit/test_pt_parity.py:218-220
    ll = -0.5 * torch.sum((x - 1.0) ** 2)
    return ll, 2.0 * ll, x


def lp_box(x):
    return torch.where(torch.all(torch.abs(x) < 4.0), 0.0, -torch.inf)


def carries_of(s):
    return [{k: v.clone() for k, v in c.items()} if isinstance(c, dict)
            else c for c in s._move_carries]


_FULL = np.array([[1.5, 0.4], [0.4, 0.8]])
EXACT = "exact"  # batched == loop bit for bit
PRODUCTS = "products"  # the ensemble moves' batched matmuls: to 1e-5


@pytest.mark.parametrize("make,kw,hold", [
    (lambda: moves.MALAMove(0.5), {}, EXACT),
    (lambda: moves.MALAMove(0.5, cov=0.7, tune_target=0.5),
     dict(tune=True), EXACT),
    (lambda: moves.MALAMove(0.5, cov=_FULL), {}, EXACT),
    (lambda: moves.HMCMove(0.3, n_leapfrog=3, jitter=0.2), {}, EXACT),
    (lambda: moves.HMCMove(0.3, n_leapfrog=2, cov=np.array([0.5, 1.5]),
                           tune_target=0.6), dict(tune=True), EXACT),
    (lambda: moves.HMCMove(0.3, n_leapfrog=2, jitter=0.2, cov=_FULL), {},
     EXACT),
    (lambda: [(moves.MALAMove(0.5), 0.6), (moves.StretchMove(), 0.4)],
     dict(mixture_block=1), EXACT),
    (lambda: moves.EnsembleMALAMove(0.8), {}, PRODUCTS),
    (lambda: moves.EnsembleHMCMove(0.4, n_leapfrog=2, tune_target=0.5),
     dict(tune=True), PRODUCTS),
    (lambda: [(moves.EnsembleHMCMove(0.4, n_leapfrog=2), 0.5),
              (moves.StretchMove(), 0.5)], dict(mixture_block=2), PRODUCTS),
])
def test_batched_path_equals_the_per_rung_loop(make, kw, hold):
    """Every rung at once (K11-K13 and K2 with the rung axis, the gradient
    over ``T * n`` rows) against the forced per-rung loop: chain, logL,
    logP, the blobs ``(2 logL, x)``, acceptance, swaps, random state and
    the tuned carries, bit for bit (the ensemble moves to rtol = atol =
    1e-5, the acceptance and swaps exactly); the box prior rejects some
    proposals, so its ``-inf`` branch runs."""
    kw = dict(kw)
    tune = kw.pop("tune", False)
    ends = []
    for batched in (True, False):
        s = PTSampler(3, 16, 2, ll_blobs, lp_box, moves=make(), seed=11,
                      device="cpu", **kw)
        s._batched = batched
        start = np.random.default_rng(2).normal(size=(3, 16, 2))
        s.run_mcmc(start, 4, thin_by=2, tune=tune)
        s.run_mcmc(None, 3, tune=tune)
        blobs = s.get_blobs()
        ends.append(((s.get_chain(), s.get_log_like(), s.get_log_prior(),
                      np.asarray(blobs[0]), np.asarray(blobs[1])),
                     (s.backend.accepted, s.swaps_accepted,
                      s.swaps_proposed, s.backend.random_state),
                     carries_of(s)))
    for x, y in zip(ends[0][1], ends[1][1]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for x, y in zip(ends[0][0], ends[1][0]):
        if hold == EXACT:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        else:
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), TOL,
                                       TOL)
    assert 0 < ends[0][1][0].sum() < 11 * 3 * 16
    for a, b in zip(ends[0][2], ends[1][2]):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                if hold == EXACT:
                    assert torch.equal(a[k], b[k]), k
                else:
                    close(a[k], b[k])
    if tune:
        assert int(ends[0][2][0]["t"][0]) == 11
        assert not torch.equal(ends[0][2][0]["log_adj"], torch.zeros(3))


def test_rung_batched_flags():
    """The four moves and ChEES propose every rung at once; a user's
    subclass that turns the flag off is refused on the rung axis."""
    for mv in (moves.MALAMove(0.5), moves.HMCMove(0.5),
               moves.EnsembleMALAMove(), moves.EnsembleHMCMove(),
               moves.ChEESHMCMove(0.5)):
        assert mv.rung_batched, type(mv).__name__

    class OneAtATime(moves.HMCMove):
        rung_batched = False

    with pytest.raises(ValueError, match="one ensemble"):
        OneAtATime(0.5).propose_rungs(
            (rung_keys(0, 2, "cpu"), 0), State(torch.zeros(2, 4, 2),
                                               torch.zeros(2, 4)),
            port_model(BETAS[:2], 4), ())
