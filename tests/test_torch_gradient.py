"""The port's gradient moves against the JAX package.

Exact under JAX's own draws: each JAX move's normals, jitter and accept
uniforms are made from the key it splits (``emcee_tpu/moves/
gradient.py:214, 298, 652, 727-740``) and injected into the port's move
(``extra=``, ``log_u=``).  Then the proposal ``q`` (a JAX run from
log-prob -inf accepts every walker), the factors (the reductions the JAX
move hands to ``Model.psum_params``, recorded) and the next state agree
for every move x preconditioner (``id``, ``scalar``, ``diag``, ``full``)
x HMC ``n_leapfrog`` in {1, 3} x jitter in {0, 0.2}, and for both splits
of the ensemble moves, on a non-Gaussian target whose gradient is not
linear.  Tolerance: rtol = atol = 1e-5 (XLA may contract a multiply and
an add into an FMA, and reduces in another order; the port rounds each
operation, ROADMAP section 3).  Chains re-run the JAX step from the
port's state before each proposal (float32 rounding compounds along a
chain).  Also: ``batch_grad`` against ``jax.grad`` with
``vectorize=True`` / ``False``, blobs and ``parameter_names``; the one
forward pass at ``q`` against ``compute_log_prob``, bit for bit; every
constructor ``ValueError``; the refusal of a log-prob without a
gradient; the tune flag reaching a ``wants_tune_flag`` move only in a
tuning run, through the graph path and the eager path; an ensemble move
inside a ``BlendedMove`` with ``StretchMove()`` against the JAX blend.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu import moves as jmoves
from emcee_tpu.model import Model as JModel
from emcee_tpu.model import wrap_log_prob_fn as jwrap
from emcee_tpu.moves.gradient import _batch_grad
from emcee_tpu.state import State as JState

import emcee_tpu_torch
from emcee_tpu_torch import moves
from emcee_tpu_torch.chunk_graph import ChunkProgram
from emcee_tpu_torch.model import Model, wrap_log_prob_fn
from emcee_tpu_torch.moves import gradient
from emcee_tpu_torch.moves.gradient import batch_grad, batch_value_and_grad
from emcee_tpu_torch.ops.philox import sub_seed
from emcee_tpu_torch.state import State

NW, ND = 32, 3
TOL = 1e-5
_A = np.random.default_rng(11).normal(size=(ND, ND))
COVS = {"id": None, "scalar": 1.7, "diag": np.array([0.5, 1.3, 2.0]),
        "full": _A @ _A.T + 0.5 * np.eye(ND)}


def lp_t(x):
    """A non-Gaussian target: quartic tails, a sine ripple, a coupling."""
    return (-0.5 * (x**2).sum(-1) - 0.05 * (x**4).sum(-1)
            + 0.3 * torch.sin(x).sum(-1) + 0.2 * x[..., 0] * x[..., 1])


def lp_j(x):
    return (-0.5 * jnp.sum(x**2, -1) - 0.05 * jnp.sum(x**4, -1)
            + 0.3 * jnp.sum(jnp.sin(x), -1) + 0.2 * x[..., 0] * x[..., 1])


def model(nw=NW):
    return Model(wrap_log_prob_fn(lp_t, vectorize=True), nw, ND)


class Spy(JModel):
    """The JAX model, recording the per-walker reductions the gradient
    moves hand to ``psum_params`` (their factors' sums) in the ``log``
    list of a subclass (:func:`spy`)."""

    def psum_params(self, x):
        self.log.append(np.asarray(x))
        return x


def spy(log):
    cls = type("Spy", (Spy,), {"log": log})
    return cls(lambda x: (lp_j(x), None), nwalkers=NW, ndim=ND)


def t(a):
    return torch.from_numpy(np.array(a))


def jx(v):
    """A JAX copy of a port tensor.  The port updates its state and carry
    in place, and on the CPU JAX may alias a numpy buffer that an
    asynchronously dispatched step is still reading."""
    return jnp.array(v.numpy(), copy=True)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), tol, tol)


def start(seed=0, nw=NW):
    x = np.random.default_rng(seed).normal(size=(nw, ND)).astype(np.float32)
    return x, np.asarray(lp_j(jnp.asarray(x)))


def carries(jmove, move, log_adj):
    """Equal tuning carries of both packages (``()`` without one)."""
    jc = jmove.init_carry(NW, ND)
    c = move.init_carry(NW, ND, device="cpu")
    if isinstance(c, dict):
        c["log_adj"].fill_(log_adj)
        c["t"].fill_(3)
        jc = {k: jx(v) for k, v in c.items()}
    return jc, c


def jax_draws(key, kind, jitter=0.0, nw=NW):
    """The draws the JAX move makes from ``key``: port ``extra`` and the
    accept ``log_u``."""
    f32 = jnp.float32
    if kind == "mala":
        k_noise, k_acc = jax.random.split(key)
        extra = {"z": t(jax.random.normal(k_noise, (nw, ND), f32))}
    else:
        k_mom, k_acc, k_jit = jax.random.split(key, 3)
        extra = {"p0": t(jax.random.normal(k_mom, (nw, ND), f32))}
        if jitter:
            extra["v"] = t(jax.random.uniform(k_jit, (), f32, -1.0, 1.0))
    log_u = t(jnp.log(jax.random.uniform(k_acc, (nw,), dtype=f32)))
    return extra, log_u


MOVES = ([("mala", c, 1, 0.0) for c in COVS]
         + [("hmc", c, n, j) for c in COVS for n in (1, 3)
            for j in (0.0, 0.2)])


def make(kind, cov, n, jitter, tune_target=None):
    kw = dict(cov=COVS[cov], tune_target=tune_target)
    if kind == "mala":
        return (jmoves.MALAMove(0.6, **kw), moves.MALAMove(0.6, **kw))
    kw.update(n_leapfrog=n, jitter=jitter)
    return jmoves.HMCMove(0.3, **kw), moves.HMCMove(0.3, **kw)


def port_q_and_factors(move, kind, x, carry, extra):
    """The port's ``q`` and factors of one proposal under ``extra``."""
    xt = torch.from_numpy(x)
    m = model()
    eps = move._eps(carry, xt)
    metric = move._metric(ND, xt.device)
    vag = batch_value_and_grad(m)
    if kind == "mala":
        q, f, _, _ = gradient._mala(xt, batch_grad(m)(xt), eps, metric, vag,
                                    (0, 0), extra["z"])
    else:
        if move.jitter:
            eps = gradient._jittered(eps, move.jitter, extra["v"])
        q, f, _, _ = gradient._hmc(xt, eps, metric, batch_grad(m), vag,
                                   extra["p0"], move.n_leapfrog)
    return q, f


def jax_factors(jmove, kind, log, carry):
    if kind == "hmc":
        return 0.5 * log[0]
    eps = jnp.asarray(jmove.step_size, jnp.float32)
    if isinstance(carry, dict):
        eps = eps * jnp.exp(carry["log_adj"])
    return (log[0] - log[1] / eps**2) / 2.0


@pytest.mark.parametrize("kind,cov,n,jitter", MOVES)
def test_proposal_matches_jax_under_its_draws(kind, cov, n, jitter):
    tuned = cov in ("diag", "full")
    jmove, move = make(kind, cov, n, jitter, 0.5 if tuned else None)
    jc, c = carries(jmove, move, 0.3)
    x, lp = start(1)
    key = jax.random.key(7)
    extra, log_u = jax_draws(key, kind, jitter)
    # q: from log-prob -inf the JAX move accepts every walker.
    log = []
    jq = jmove.propose(key, JState(jnp.asarray(x), jnp.full(NW, -jnp.inf)),
                       spy(log), jc)[0].coords
    q, f = port_q_and_factors(move, kind, x, c, extra)
    close(q, jq)
    close(f, jax_factors(jmove, kind, log, jc))
    # The next state and the acceptance.
    want, jacc, _ = jmove.propose(key, JState(jnp.asarray(x),
                                              jnp.asarray(lp)), spy([]), jc)
    st = State(torch.from_numpy(x.copy()), torch.from_numpy(lp.copy()))
    st, acc, _ = move.propose((5, 0), st, model(), c, extra=extra,
                              log_u=log_u)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    close(st.coords, want.coords)
    close(st.log_prob, want.log_prob)


@pytest.mark.parametrize("kind,cov,jitter", [("mala", "diag", 0.0),
                                             ("hmc", "full", 0.2)])
def test_chain_matches_jax_step_by_step(kind, cov, jitter):
    """Eight proposals with a tuned carry; each JAX step from the port's
    state and carry."""
    jmove, move = make(kind, cov, 3, jitter, tune_target=0.5)
    c = move.init_carry(NW, ND, device="cpu")
    x, lp = start(2)
    st = State(t(x), t(lp))
    for step in range(8):
        key = jax.random.key(100 + step)
        extra, log_u = jax_draws(key, kind, jitter)
        jc = {k: jx(v) for k, v in c.items()}
        want, jacc, jc = jmove.propose(
            key, JState(jx(st.coords),
                        jx(st.log_prob)), spy([]), jc)
        jc = jmove.tune(jc, want, jacc)
        st, acc, c = move.propose((5, step), st, model(), c, extra=extra,
                                  log_u=log_u)
        c = move.tune(c, st, acc)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
        close(st.coords, want.coords)
        close(st.log_prob, want.log_prob)
        for k, v in jc.items():
            close(c[k], v)


def ensemble_draws(key, cls, jitter, ng):
    f32 = jnp.float32
    if cls == "mala":
        return {"z": t(jax.random.normal(key, (ng, ND), f32))}
    k_mom, k_jit = jax.random.split(key)
    d = {"p0": t(jax.random.normal(k_mom, (ng, ND), f32))}
    if jitter:
        d["v"] = t(jax.random.uniform(k_jit, (), f32, -1.0, 1.0))
    return d


ENSEMBLE = ([("mala", 1, 0.0)]
            + [("hmc", n, j) for n in (1, 3) for j in (0.0, 0.2)])


def ensemble_pair(cls, n, jitter, **kw):
    if cls == "mala":
        return (jmoves.EnsembleMALAMove(0.9, **kw),
                moves.EnsembleMALAMove(0.9, **kw))
    kw.update(n_leapfrog=n, jitter=jitter)
    return (jmoves.EnsembleHMCMove(0.4, **kw),
            moves.EnsembleHMCMove(0.4, **kw))


@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("cls,n,jitter", ENSEMBLE)
def test_ensemble_proposal_matches_jax_under_its_draws(cls, n, jitter,
                                                       split):
    jmove, move = ensemble_pair(cls, n, jitter)
    x, _ = start(3)
    ng = NW // 2
    s = x[split * ng:(split + 1) * ng]
    c = x[(1 - split) * ng:(2 - split) * ng]
    key = jax.random.key(20 + split)
    scale = 1.2
    jq, jf = jmove.get_proposal(key, jnp.asarray(s), (c,), spy([]),
                                scale=jnp.float32(scale))
    q, f = move.get_proposal((1, 2), torch.from_numpy(x), split, model(),
                             extra=ensemble_draws(key, cls, jitter, ng),
                             scale=torch.tensor(scale))
    close(q, jq)
    close(f, jf)


@pytest.mark.parametrize("cls,n,jitter", [("mala", 1, 0.0),
                                          ("hmc", 3, 0.2)])
def test_ensemble_next_state_matches_jax(cls, n, jitter):
    """Both splits of the blocked engine under JAX's split keys and
    accept uniforms, four proposals, each from the port's state."""
    jmove, move = ensemble_pair(cls, n, jitter, randomize_split=False)
    x, lp = start(4)
    ng = NW // 2
    st = State(t(x), t(lp))
    for step in range(4):
        keys = jax.random.split(jax.random.key(30 + step), 3)
        log_acc_u = jnp.log(jax.random.uniform(keys[0], (2, ng)))
        want, jacc, _ = jmove._propose_blocked(
            keys[1:], log_acc_u, None,
            JState(jx(st.coords),
                   jx(st.log_prob)), spy([]), (), ng)
        st, acc, _ = move._propose_blocked(
            (6, step), st, model(), (), ng, log_acc_u=t(log_acc_u),
            extra_u=[ensemble_draws(k, cls, jitter, ng) for k in keys[1:]])
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
        close(st.coords, want.coords)
        close(st.log_prob, want.log_prob)


@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("cls,n,jitter", [("mala", 1, 0.0),
                                          ("hmc", 3, 0.2)])
def test_ensemble_move_in_a_blend_matches_jax(cls, n, jitter, split):
    """An ensemble gradient move blended with ``StretchMove()``: its
    proposal through the port's ``BlendedMove`` against the JAX blend's
    (``emcee_tpu/moves/blended.py``: the gradient move draws under the
    blend's ``keys[1]``, injected here), and the stretch branch against
    ``StretchMove`` alone under its sub-move key, bit for bit."""
    jmove, move = ensemble_pair(cls, n, jitter)
    x, _ = start(5)
    ng = NW // 2
    s = x[split * ng:(split + 1) * ng]
    c = x[(1 - split) * ng:(2 - split) * ng]
    key = jax.random.key(40 + split)
    jblend = jmoves.BlendedMove([(jmove, 1.0), (jmoves.StretchMove(), 0.0)])
    jq, jf = jblend.get_proposal(key, jnp.asarray(s), (c,), spy([]))
    draws = ensemble_draws(jax.random.split(key, 3)[1], cls, jitter, ng)
    blend = moves.BlendedMove([(move, 1.0), (moves.StretchMove(), 0.0)])
    xt = torch.from_numpy(x)
    q, f = blend.get_proposal((9, 4), xt, split, model(),
                              extra={"moves": [draws, None]})
    close(q, jq)
    close(f, jf)
    q1, f1 = blend.get_proposal((9, 4), xt, split, model(),
                                extra={"choice": 1})
    q2, f2 = moves.StretchMove().get_proposal(
        (sub_seed(9, 1), 4), xt, split, model())
    assert torch.equal(q1, q2) and torch.equal(f1, f2.expand(ng))


@pytest.mark.parametrize("cls", [moves.EnsembleMALAMove,
                                 moves.EnsembleHMCMove])
def test_ensemble_move_blended_with_stretch_runs(cls):
    """``BlendedMove([EnsembleMALAMove(), StretchMove()])`` (and HMC)
    through ``EnsembleSampler``: the engine reaches each sub-move through
    its own hook."""
    s = emcee_tpu_torch.EnsembleSampler(
        16, ND, lp_t, vectorize=True, seed=2, device="cpu",
        moves=moves.BlendedMove([cls(0.4), moves.StretchMove()]))
    s.run_mcmc(np.random.default_rng(3).normal(size=(16, ND)), 20)
    assert np.isfinite(s.get_chain()).all()
    assert 0.2 < s.acceptance_fraction.mean() < 1.0


def lp1_t(x):
    return -0.5 * (x**2).sum() + 0.3 * torch.sin(x).sum() + x[0] * x[-1]


def lp1_j(x):
    return -0.5 * jnp.sum(x**2) + 0.3 * jnp.sum(jnp.sin(x)) + x[0] * x[-1]


def lpn_t(p):
    return -0.5 * (p["a"] ** 2 + (p["b"] ** 2).sum()) + torch.sin(
        p["a"]) * p["b"][0]


def lpn_j(p):
    return -0.5 * (p["a"] ** 2 + jnp.sum(p["b"] ** 2)) + jnp.sin(
        p["a"]) * p["b"][0]


GRAD_CASES = {
    "vectorized": (lp_t, lp_j, dict(vectorize=True)),
    "per_walker": (lp1_t, lp1_j, dict(vectorize=False)),
    "vectorized_blobs": (lambda x: (lp_t(x), x.sum(-1), {"m": x * 2.0}),
                         lambda x: (lp_j(x), x.sum(-1), {"m": x * 2.0}),
                         dict(vectorize=True)),
    "per_walker_blobs": (lambda x: (lp1_t(x), x[0]),
                         lambda x: (lp1_j(x), x[0]), dict(vectorize=False)),
    "named": (lpn_t, lpn_j, dict(vectorize=False,
                                 parameter_names={"a": 0, "b": [1, 2]})),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_batch_grad_matches_jax_grad(case):
    ft, fj, kw = GRAD_CASES[case]
    x, _ = start(5)
    m = Model(wrap_log_prob_fn(ft, **kw), NW, ND)
    jm = JModel(jwrap(fj, **kw), nwalkers=NW, ndim=ND)
    close(batch_grad(m)(torch.from_numpy(x)), _batch_grad(jm)(jnp.asarray(x)))
    # One forward pass gives compute_log_prob's log-prob and blobs, bit for
    # bit, and batch_grad's gradient.
    q = torch.from_numpy(x) * 0.7
    lp, blobs, g = batch_value_and_grad(m)(q)
    lp2, blobs2 = m.compute_log_prob(q)
    assert torch.equal(lp, lp2)
    assert torch.equal(g, batch_grad(m)(q))
    leaves = emcee_tpu_torch.utils.tree_flatten(blobs)
    leaves2 = emcee_tpu_torch.utils.tree_flatten(blobs2)
    assert leaves[1] == leaves2[1]
    assert all(torch.equal(a, b) for a, b in zip(leaves[0], leaves2[0]))


@pytest.mark.parametrize("make_move", [
    lambda: moves.MALAMove(0.5), lambda: moves.HMCMove(0.5),
    lambda: moves.ChEESHMCMove(0.5), lambda: moves.EnsembleMALAMove(),
    lambda: moves.EnsembleHMCMove()])
def test_refuses_a_log_prob_without_a_gradient(make_move):
    """The JAX package's refusal of a non-differentiable log-prob
    (``gradient.py:75-83``), at the move."""
    m = model()._replace(grad_ok=False)
    x, lp = start(6)
    st = State(t(x), t(lp))
    mv = make_move()
    with pytest.raises(NotImplementedError, match="differentiable"):
        mv.propose((0, 0), st, m, mv.init_carry(NW, ND, device="cpu"))


VALUE_ERRORS = [
    ("MALAMove", (0.0,), {}),
    ("HMCMove", (0.5,), {"n_leapfrog": 0}),
    ("HMCMove", (0.5,), {"jitter": 1.5}),
    ("ChEESHMCMove", (0.5,), {"trajectory_length": 0.0}),
    ("ChEESHMCMove", (0.5,), {"max_leapfrog": 0}),
    ("ChEESHMCMove", (0.5,), {"adapt_rate": -1.0}),
    ("MALAMove", (0.5,), {"cov": -1.0}),
    ("HMCMove", (0.5,), {"cov": np.array([1.0, -2.0])}),
    ("MALAMove", (0.5,), {"cov": np.array([1.0, np.nan])}),
    ("MALAMove", (0.5,), {"cov": np.ones((2, 3))}),
    ("EnsembleHMCMove", (), {"step_size": -1.0}),
    ("EnsembleHMCMove", (), {"n_leapfrog": 0}),
    ("EnsembleHMCMove", (), {"jitter": 1.5}),
    ("EnsembleMALAMove", (), {"step_size": 0.0}),
]


@pytest.mark.parametrize("name,args,kw", VALUE_ERRORS)
def test_constructor_errors_match_jax(name, args, kw):
    for mod in (jmoves, moves):
        with pytest.raises(ValueError):
            getattr(mod, name)(*args, **kw)


def test_constructor_defaults_match_jax():
    with pytest.raises(np.linalg.LinAlgError):
        moves.MALAMove(0.5, cov=-np.eye(2))
    for name, args in (("MALAMove", (0.5,)), ("HMCMove", (0.5,)),
                       ("ChEESHMCMove", (0.5,)), ("EnsembleMALAMove", ()),
                       ("EnsembleHMCMove", ())):
        a, b = getattr(moves, name)(*args), getattr(jmoves, name)(*args)
        for attr in ("step_size", "n_leapfrog", "jitter", "tune_target",
                     "tune_rate", "ridge", "trajectory_length",
                     "max_leapfrog", "adapt_rate", "nsplits",
                     "randomize_split", "tunable", "wants_tune_flag",
                     "_precond"):
            if hasattr(b, attr):
                assert getattr(a, attr) == getattr(b, attr), (name, attr)
    assert moves.ChEESHMCMove(0.5).wants_tune_flag
    assert not moves.MALAMove(0.5).wants_tune_flag


class TuneFlagMove(moves.MHMove):
    """A whole-proposal move that records the tune flag it is given."""

    wants_tune_flag = True

    def __init__(self, seen):
        super().__init__(lambda rng, x: (x + 0.1, torch.zeros(x.shape[0])))
        self.seen = seen

    def propose(self, rng, state, model, carry, acc_count=None,
                accepted=None, tune=None):
        self.seen.append(tune)
        return super().propose(rng, state, model, carry, acc_count,
                               accepted)


class FakeGraph:
    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


@pytest.mark.parametrize("graphs", [False, True])
def test_tune_flag_reaches_a_tune_flag_move_only_when_tuning(graphs,
                                                             monkeypatch):
    """``wants_tune_flag`` (``emcee_tpu/sampler.py:733-738``): the chunk
    program passes ``tune=`` the run's flag to such a move, in whole
    proposals and in a looped move's proposals, recorded (a stand-in
    graph that runs what it recorded) or eager."""
    monkeypatch.setattr(ChunkProgram, "_capture",
                        lambda self, fn, what: FakeGraph(fn))
    monkeypatch.setattr(ChunkProgram, "_record",
                        lambda self, i, n, tune: FakeGraph(
                            lambda: self.program(self.ws, i, n, tune)))
    monkeypatch.setattr(ChunkProgram, "_warm_up",
                        lambda self, i, tune: self.program(
                            self.ws.clone(), i, 1, tune))
    seen = []
    chees = moves.ChEESHMCMove(0.3, trajectory_length=0.6)
    smp = emcee_tpu_torch.EnsembleSampler(
        16, 2, lambda x: -0.5 * (x**2).sum(-1), vectorize=True, seed=1,
        device="cpu", moves=[(TuneFlagMove(seen), 0.5), (chees, 0.5)])
    smp._use_graphs = graphs
    p0 = np.random.default_rng(0).normal(size=(16, 2))
    smp.run_mcmc(p0, 12, tune=True)
    tuned = list(seen)
    assert float(smp._move_carries[1]["k"]) > 0
    assert float(smp._move_carries[1]["g"]) != 0.0
    smp.run_mcmc(None, 12)
    assert tuned and all(v is True for v in tuned)
    assert seen[len(tuned):] and all(v is False for v in seen[len(tuned):])
    # Production proposals estimate no ChEES gradient (gradient.py:546-548).
    assert float(smp._move_carries[1]["g"]) == 0.0


def test_count_launches_adds_to_the_device_word_only_when_set():
    """Every wrapper counts through ``count_launches``: its host count,
    and a device word only while a caller has set one."""
    from emcee_tpu_torch.ops import (_wrap, accept_kernel, de_kernel,
                                     langevin_kernel, snooker_kernel,
                                     stretch_kernel)

    for fn in (accept_kernel.accept_select, de_kernel.de_propose,
               snooker_kernel.snooker_propose,
               stretch_kernel.stretch_propose, langevin_kernel.langevin_step,
               langevin_kernel.langevin_factor, langevin_kernel.leapfrog):
        assert fn.device_launches is None

    def fn():
        pass

    fn.launches, fn.device_launches = 0, None
    _wrap.count_launches(fn)
    assert fn.launches == 1
    fn.device_launches = torch.zeros((), dtype=torch.int64)
    _wrap.count_launches(fn, 3)
    assert fn.launches == 4 and int(fn.device_launches) == 3


@pytest.mark.parametrize("cls", ["hmc", "ensemble"])
def test_hmc_draws_its_jitter_beside_its_momenta(cls):
    """Without ``extra`` an HMC move draws ``p0`` and the jitter's ``v``
    in one K11 call; the result is the proposal under the injected
    ``p0 = normals(...)`` and ``v = 2 grad_uniform(...) - 1``."""
    from emcee_tpu_torch.ops import langevin_kernel
    from emcee_tpu_torch.ops.philox import grad_uniform, normals

    x, lp = start(5)
    rng = (9, 4)
    if cls == "hmc":
        move = moves.HMCMove(0.3, n_leapfrog=2, jitter=0.2)
        extra = {"p0": normals(NW, ND, *rng, "cpu"),
                 "v": grad_uniform(rng[0], 0, rng[1], "cpu") * 2.0 - 1.0}
        ends = []
        for e in (None, extra):
            st = State(t(x), t(lp))
            st, acc, _ = move.propose(rng, st, model(), (), extra=e)
            ends.append((st.coords, st.log_prob, acc))
    else:
        move = moves.EnsembleHMCMove(0.4, n_leapfrog=2, jitter=0.2)
        ng, split = NW // 2, 1
        extra = {"p0": normals(ng, ND, *rng, "cpu", row0=ng),
                 "v": grad_uniform(rng[0], split, rng[1], "cpu") * 2.0 - 1.0}
        ends = [move.get_proposal(rng, t(x), split, model(), extra=e,
                                  scale=torch.tensor(1.1))
                for e in (None, extra)]
    for a, b in zip(*ends):
        assert torch.equal(a, b)
    # The jitter alone, with no rows.
    v = torch.empty(())
    langevin_kernel.langevin_step((0, ND), "cpu", seed=9, offset=4, v=v,
                                  v_split=1)
    assert torch.equal(v, grad_uniform(9, 1, 4, "cpu") * 2.0 - 1.0)
