"""The port's PTSampler (``emcee_tpu_torch/parallel/tempering.py``)
against the JAX package's (``emcee_tpu/parallel/tempering.py``).

Exact, under injected uniforms (the same numpy-seeded inputs to both
packages; float32 rounding, rtol 1e-5 and atol 1e-6 where the two
compilers round the proposal differently, identical acceptance):
K1's plain version with the rung axis against ``StretchMove.get_proposal
(extra=)`` rung by rung, and one tempered split through the rung-batched
engine against JAX's ``RedBlueMove._inner`` under
``pt._tempered_model(beta_r)``.  Exact within the port, bit for bit: the
rung-batched path against the per-rung loop, and a 1-rung ladder at
``beta = 1`` against ``EnsembleSampler`` of the same seed.  The host
arithmetic (``default_beta_ladder``, ``_count_proposed_delta``,
``log_evidence_estimate`` on a JAX run's stored chain) equals JAX's.
Then the port's own contracts (``sample`` == ``run_mcmc``, resume,
refusals) and the statistical twins of ``tests/unit/test_tempering.py``
(mode hopping ``:41``, single temperature ``:81``, log evidence
``:128``, the per-rung loop with DE and MALA ``:273``); the long ones
are ``slow``.  JAX runs on the CPU (tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu import moves as jmoves
from emcee_tpu.model import Model as JModel
from emcee_tpu.parallel.tempering import PTSampler as JPTSampler
from emcee_tpu.parallel.tempering import default_beta_ladder as j_ladder

import emcee_tpu_torch
from emcee_tpu_torch import EnsembleSampler, PTSampler, moves
from emcee_tpu_torch.chunk_graph import TemperedLogProb
from emcee_tpu_torch.convert import pt_backend_from_numpy
from emcee_tpu_torch.model import Model, wrap_log_prob_fn
from emcee_tpu_torch.ops.philox import rung_keys
from emcee_tpu_torch.ops.stretch_kernel import stretch_propose_plain
from emcee_tpu_torch.ops.swap_kernel import tempered_log_prob
from emcee_tpu_torch.parallel import PTState, default_beta_ladder
from emcee_tpu_torch.state import State
from tests.test_torch_mh_gaussian import philox_mh

RTOL, ATOL = 1e-5, 1e-6


def ll_bimodal(x):  # one walker (vmapped), as test_tempering.py:23-26
    a = -0.5 * torch.sum((x - 5.0) ** 2)
    b = -0.5 * torch.sum((x + 5.0) ** 2)
    return torch.logaddexp(a, b)


def lp_box(x):  # :29-30
    return torch.where(torch.all(torch.abs(x) < 20.0), 0.0, -torch.inf)


def j_ll_bimodal(x):
    a = -0.5 * jnp.sum((x - 5.0) ** 2)
    b = -0.5 * jnp.sum((x + 5.0) ** 2)
    return jnp.logaddexp(a, b)


def j_lp_box(x):
    return jnp.where(jnp.all(jnp.abs(x) < 20.0), 0.0, -jnp.inf)


def ll_batch(x):
    return -0.5 * (x**2).sum(-1)


def lp_batch(x):
    return torch.where((x.abs() < 3.0).all(-1), 0.0, -torch.inf)


def pt(T=4, nw=16, nd=2, **kw):
    kw.setdefault("seed", 3)
    return PTSampler(T, nw, nd, ll_bimodal, lp_box, device="cpu", **kw)


def p0(T=4, nw=16, nd=2, seed=0):
    return np.random.default_rng(seed).normal(size=(T, nw, nd)) * 2.0


def test_default_beta_ladder_matches_jax():
    for args in ((8, 5), (16, 5, None), (6, 1, 1e6), (1, 3)):
        np.testing.assert_array_equal(default_beta_ladder(*args),
                                      j_ladder(*args))


@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("tuned", [False, True])
def test_k1_rung_axis_matches_jax_get_proposal(split, tuned):
    """Roll pairs, whose draws JAX takes from ``extra`` (its random mode
    draws the partner by ``randint``, which no injection reaches; the
    rung axis's random mode is held to the single ensemble below)."""
    rng = np.random.default_rng(1 + tuned + 2 * split)
    T, nw, nd, ns = 3, 12, 2, 2
    ng = nw // ns
    coords = rng.normal(size=(T, nw, nd)).astype(np.float32)
    extra = rng.uniform(size=(T, ng + 1)).astype(np.float32)
    scale = (np.array([0.7, 1.3, 1.0], np.float32) if tuned else None)
    jmove = jmoves.StretchMove(pair_mode="roll")
    jmodel = JModel(compute_log_prob=None, nwalkers=nw)
    q, f = stretch_propose_plain(
        torch.tensor(coords), split, ns, a=2.0, ndim_global=nd,
        pair_mode="roll", scale=None if scale is None
        else torch.tensor(scale), u_z=torch.tensor(extra[:, :ng]),
        u_shift=torch.tensor(extra[:, ng]))
    assert q.shape == (T, ng, nd) and f.shape == (T, ng)
    for r in range(T):
        s = jnp.asarray(coords[r, split * ng:(split + 1) * ng])
        c_parts = (jnp.asarray(coords[r, (1 - split) * ng:(2 - split) * ng]),)
        jq, jf = jmove.get_proposal(
            jax.random.key(0), s, c_parts, jmodel,
            extra=jnp.asarray(extra[r]),
            scale=None if scale is None else jnp.float32(scale[r]))
        np.testing.assert_allclose(q[r].numpy(), np.asarray(jq), RTOL, ATOL)
        np.testing.assert_allclose(f[r].numpy(), np.asarray(jf), RTOL, ATOL)


@pytest.mark.parametrize("pair_mode", ["roll", "random"])
@pytest.mark.parametrize("draws", ["injected", "stream"])
def test_rung_axis_plain_versions_equal_each_rung_alone(pair_mode, draws):
    """K1's and K2's plain versions on the rung axis equal the
    single-ensemble plain versions rung by rung under each rung's key,
    bit for bit (the kernels are held to these on the card)."""
    from emcee_tpu_torch.ops.accept_kernel import accept_select_plain

    rng = np.random.default_rng(5)
    T, nw, nd, ns, split = 4, 12, 3, 3, 2
    ng = nw // ns
    keys = rung_keys(31, T, "cpu")
    coords = torch.tensor(rng.normal(size=(T, nw, nd)).astype(np.float32))
    scale = torch.tensor([0.5, 1.0, 1.5, 2.0])
    inj = {}
    if draws == "injected":
        inj = dict(u_z=torch.rand(T, ng), log_u=torch.log(torch.rand(T, ng)))
        inj["u_shift" if pair_mode == "roll" else "u_pair"] = (
            torch.rand(T) if pair_mode == "roll" else torch.rand(T, ng))
    k1 = {k: v for k, v in inj.items() if k != "log_u"}
    q, f = stretch_propose_plain(coords, split, ns, a=2.0, ndim_global=nd,
                                 pair_mode=pair_mode, scale=scale, seed=keys,
                                 offset=9, **k1)
    lp = -0.5 * (coords**2).sum(-1)
    lp_q = -0.5 * (q**2).sum(-1)
    leaf = torch.randn(T, ng, 2)
    buf = torch.randn(T, nw, 2)
    c, l, b = coords.clone(), lp.clone(), buf.clone()
    acc = torch.zeros(T, nw, dtype=torch.bool)
    cnt = torch.zeros(T, nw, dtype=torch.int32)
    accept_select_plain(q, f, lp_q, c, l, split, ns, acc, cnt, seed=keys,
                        offset=9, log_u=inj.get("log_u"),
                        blobs=[(leaf, b)])
    for r in range(T):
        kr = {k: v[r] for k, v in k1.items()}
        qr, fr = stretch_propose_plain(
            coords[r], split, ns, a=2.0, ndim_global=nd,
            pair_mode=pair_mode, scale=scale[r], seed=keys.seeds[r],
            offset=9, **kr)
        assert torch.equal(qr, q[r]) and torch.equal(fr, f[r])
        cr, lr, br = coords[r].clone(), lp[r].clone(), buf[r].clone()
        ar = torch.zeros(nw, dtype=torch.bool)
        nr = torch.zeros(nw, dtype=torch.int32)
        accept_select_plain(
            qr, fr, lp_q[r], cr, lr, split, ns, ar, nr, seed=keys.seeds[r],
            offset=9, log_u=None if "log_u" not in inj else inj["log_u"][r],
            blobs=[(leaf[r], br)])
        for x, y in ((cr, c[r]), (lr, l[r]), (ar, acc[r]), (nr, cnt[r]),
                     (br, b[r])):
            assert torch.equal(x, y)
    assert 0 < int(acc.sum()) < T * ng


@pytest.mark.parametrize("split", [0, 1])
def test_tempered_split_matches_jax_inner(split):
    """One split of every rung through the rung-batched engine (K1, the
    tempered log-prob over T * ng rows, K2 with the logL / logP leaves)
    against JAX's _inner under the rung's tempered model: identical
    acceptance, the same rows, logL and logP; a prior of -inf masks logL
    to 0 and the log-prob to -inf."""
    rng = np.random.default_rng(7 + split)
    T, nw, nd, ns = 4, 16, 2, 2
    ng = nw // ns
    betas = default_beta_ladder(T, nd).astype(np.float32)
    coords = (2.0 * rng.normal(size=(T, nw, nd))).astype(np.float32)
    jpt = JPTSampler(T, nw, nd, lambda x: -0.5 * jnp.sum(x**2),
                     lambda x: jnp.where(jnp.all(jnp.abs(x) < 3.0), 0.0,
                                         -jnp.inf),
                     betas=betas)
    flat = coords.reshape(-1, nd)
    ll = (-0.5 * (flat**2).sum(-1)).reshape(T, nw).astype(np.float32)
    lpr = np.where(np.abs(coords).max(-1) < 3.0, 0.0, -np.inf).astype(
        np.float32)
    extra = rng.uniform(size=(T, ng + 1)).astype(np.float32)
    log_u = np.log(rng.uniform(size=(T, ng))).astype(np.float32)

    mv = moves.StretchMove(pair_mode="roll", randomize_split=False)
    t_betas = torch.tensor(betas)
    model = Model(TemperedLogProb(wrap_log_prob_fn(ll_batch, vectorize=True),
                                  wrap_log_prob_fn(lp_batch, vectorize=True),
                                  t_betas), nwalkers=nw, ndim=nd)
    c, l, p = (torch.tensor(x) for x in (coords, ll, lpr))
    lp = tempered_log_prob(t_betas[:, None], l, p)
    accepted = torch.zeros(T, nw, dtype=torch.bool)
    mv._inner((rung_keys(0, T, "cpu"), 0), c, lp, split, model, accepted,
              log_u=torch.tensor(log_u), extra=torch.tensor(extra),
              blobs=(l, p))
    jmove = jmoves.StretchMove(pair_mode="roll", randomize_split=False)
    sl = slice(split * ng, (split + 1) * ng)
    masked = 0
    for r in range(T):
        jmodel = jpt._tempered_model(jnp.float32(betas[r]))
        jlp = jnp.where(lpr[r] > -np.inf, betas[r] * ll[r] + lpr[r],
                        -jnp.inf)
        s_c, s_lp, (s_ll, s_lpr, _), jacc, _ = jmove._inner(
            jax.random.key(0), jnp.asarray(coords[r, sl]),
            (jnp.asarray(coords[r, (1 - split) * ng:(2 - split) * ng]),),
            jlp[sl], (jnp.asarray(ll[r, sl]), jnp.asarray(lpr[r, sl]),
                      None),
            jnp.asarray(log_u[r]), jmodel, extra=jnp.asarray(extra[r]))
        np.testing.assert_array_equal(accepted[r, sl].numpy(),
                                      np.asarray(jacc))
        np.testing.assert_allclose(c[r, sl].numpy(), np.asarray(s_c),
                                   RTOL, ATOL)
        np.testing.assert_allclose(lp[r, sl].numpy(), np.asarray(s_lp),
                                   RTOL, ATOL)
        np.testing.assert_allclose(l[r, sl].numpy(), np.asarray(s_ll),
                                   RTOL, ATOL)
        np.testing.assert_array_equal(p[r, sl].numpy(), np.asarray(s_lpr))
        masked += int((np.asarray(s_lpr) == -np.inf).sum())
    assert masked > 0, "the -inf prior branch was not exercised"
    # logL is 0 wherever the stored prior is -inf (the tempered mask).
    assert torch.all(l[p == -torch.inf][accepted.view(-1)[
        (p == -torch.inf).view(-1)]] == 0.0)


def chain_of(s):
    return (s.get_chain(), s.get_log_like(), s.get_log_prior(),
            s.backend.accepted, s.swaps_accepted, s.swaps_proposed,
            s.backend.random_state)


def assert_same_run(a, b):
    for x, y in zip(chain_of(a), chain_of(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("mv_kw", [
    dict(),
    dict(randomize_split=False, pair_mode="roll"),
    dict(pair_mode="roll", nsplits=3),
    dict(randomize_split=False, tune_target=0.3),
])
def test_batched_path_equals_the_per_rung_loop(mv_kw):
    tune = "tune_target" in mv_kw
    runs = []
    for batched in (True, False):
        s = PTSampler(3, 18, 2, ll_bimodal, lp_box, seed=5, device="cpu",
                      moves=moves.StretchMove(**mv_kw))
        s._batched = batched
        s.run_mcmc(p0(3, 18), 12, thin_by=2, tune=tune)
        runs.append(s)
        if tune:
            assert int(s._move_carries[0]["t"][0]) == 24
    assert_same_run(*runs)
    if tune:
        for k in ("log_adj", "t"):
            assert torch.equal(runs[0]._move_carries[0][k],
                               runs[1]._move_carries[0][k])


@pytest.mark.parametrize("mv", [
    None,
    moves.StretchMove(randomize_split=False, pair_mode="roll"),
    moves.DEMove(),
    moves.DESnookerMove(),
    moves.GaussianMove(0.5),
    moves.BlendedMove([(moves.DEMove(), 0.6), (moves.SideMove(), 0.4)]),
    moves.MHMove(philox_mh),
])
def test_one_rung_at_beta_one_is_the_ensemble_sampler(mv):
    """A 1-rung ladder at beta = 1 draws exactly what EnsembleSampler
    draws for the same seed: the same chain bit for bit."""
    nw, nd = 16, 3
    start = np.random.default_rng(0).normal(size=(1, nw, nd))
    s = PTSampler(1, nw, nd, ll_batch, lambda x: torch.zeros(x.shape[0]),
                  betas=[1.0], vectorize=True, seed=7, device="cpu",
                  moves=mv)
    s.run_mcmc(start, 25)
    e = EnsembleSampler(nw, nd, lambda x: ll_batch(x) + torch.zeros(
        x.shape[0]), vectorize=True, seed=7, device="cpu", moves=mv)
    e.run_mcmc(start[0], 25)
    np.testing.assert_array_equal(s.get_chain(temp=0), e.get_chain())
    np.testing.assert_array_equal(
        s.get_log_like()[:, 0] + s.get_log_prior()[:, 0], e.get_log_prob())
    np.testing.assert_array_equal(s.backend.accepted[0], e.backend.accepted)
    assert s.backend.random_state == e.backend.random_state


@pytest.mark.parametrize("swap_every", [1, 2, 3])
def test_count_proposed_delta_matches_jax(swap_every):
    T, nw = 5, 8
    s = pt(T=T, nw=nw, swap_every=swap_every)
    j = JPTSampler(T, nw, 2, j_ll_bimodal, j_lp_box, swap_every=swap_every)
    for lo, hi in ((0, 1), (0, 7), (3, 4), (5, 17), (16, 64), (1, 100)):
        np.testing.assert_array_equal(s._count_proposed_delta(lo, hi),
                                      j._count_proposed_delta(lo, hi))


def test_swaps_proposed_count_the_steps_and_accepted_are_consistent():
    s = pt(T=4, swap_every=3)
    s.run_mcmc(p0(), 7, thin_by=2)  # steps 0-13: swaps at 2, 5, 8, 11
    np.testing.assert_array_equal(s.swaps_proposed,
                                  [2 * 16, 2 * 16, 2 * 16])
    s.run_mcmc(None, 1, store=False)  # step 14: a swap, not stored
    s.run_mcmc(None, 2)  # steps 15-16: none
    np.testing.assert_array_equal(s.swaps_proposed,
                                  [2 * 16, 2 * 16, 2 * 16])
    s.run_mcmc(None, 1)  # step 17: odd
    np.testing.assert_array_equal(s.swaps_proposed, [32, 48, 32])
    assert np.all(s.swaps_accepted <= s.swaps_proposed)
    assert np.all(s.tswap_acceptance_fraction <= 1.0)


def test_log_evidence_estimate_matches_jax_on_a_stored_chain():
    """Both methods and return_error on a JAX run's stored chain, carried
    into the port by pt_backend_from_numpy (numpy float64 on both sides:
    tolerance 1e-12)."""
    T, nw, nd = 5, 16, 1

    def ll(x):
        return -0.5 * jnp.sum(x**2)

    def lp(x):
        return jnp.where(jnp.all(jnp.abs(x) < 10.0), -jnp.log(20.0),
                         -jnp.inf)

    j = JPTSampler(T, nw, nd, ll, lp, seed=0)
    j.run_mcmc(np.random.default_rng(1).uniform(-9, 9, size=(T, nw, nd)),
               60)
    b = j.backend
    backend = pt_backend_from_numpy(
        b.get_chain(), b.get_log_like(), b.get_log_prior(), b.accepted,
        b.swaps_accepted, b.swaps_proposed, b.betas)
    s = PTSampler(T, nw, nd, lambda x: -0.5 * (x**2).sum(),
                  lambda x: torch.zeros(()), seed=0, device="cpu",
                  backend=backend)
    np.testing.assert_array_equal(s.betas, j.betas)
    assert s.iteration == 60
    for method in ("ti", "stepping-stone"):
        for discard in (0, 20):
            np.testing.assert_allclose(
                s.log_evidence_estimate(discard=discard, method=method),
                j.log_evidence_estimate(discard=discard, method=method),
                rtol=1e-12)
            np.testing.assert_allclose(
                s.log_evidence_estimate(discard, method, True),
                j.log_evidence_estimate(discard, method, True), rtol=1e-12)
    with pytest.raises(ValueError, match="unknown evidence method"):
        s.log_evidence_estimate(method="harmonic")


def test_sample_equals_run_mcmc():
    a, b = pt(), pt()
    a.run_mcmc(p0(), 6, thin_by=2)
    states = list(b.sample(p0(), iterations=6, thin_by=2))
    assert len(states) == 6 and isinstance(states[-1], PTState)
    assert states[-1].coords.shape == (4, 16, 2)
    assert_same_run(a, b)


def test_resumed_run_equals_an_uninterrupted_one():
    a, b = pt(), pt()
    a.run_mcmc(p0(), 20)
    b.run_mcmc(p0(), 8)
    b.run_mcmc(None, 5)
    b.run_mcmc(None, 7)
    assert_same_run(a, b)
    # A fresh sampler over the stored backend resumes it too.
    c = pt(backend=b.backend)
    assert c.iteration == 20
    a.run_mcmc(None, 4)
    c.run_mcmc(None, 4)
    assert_same_run(a, c)


def test_surface_shapes_and_bookkeeping():
    s = pt()
    st = s.run_mcmc(p0(), 30)
    assert isinstance(st, PTState) and st.ntemps == 4
    assert s.get_chain().shape == (30, 4, 16, 2)
    assert s.get_chain(temp=1).shape == (30, 16, 2)
    assert s.get_chain(temp=0, flat=True, discard=10).shape == (320, 2)
    assert s.get_log_like().shape == s.get_log_prior().shape == (30, 4, 16)
    assert s.acceptance_fraction.shape == (4, 16)
    assert s.last_run_stats.nwalkers == 64
    assert s.last_run_stats.acceptance_fraction.shape == (4, 16)
    assert s.get_blobs() is None
    last = s.get_last_sample()
    np.testing.assert_array_equal(last.coords, s.get_chain()[-1])
    assert last.random_state == (3, 30)
    tau = s.get_autocorr_time(temp=0, quiet=True)
    assert tau.shape == (2,)
    assert s.run_mcmc(None, 0).coords.shape == (4, 16, 2)
    s.reset()
    assert s.iteration == 0 and s.swaps_proposed.sum() == 0
    with pytest.raises(ValueError, match="incompatible input dimensions"):
        s.run_mcmc(np.zeros((3, 16, 2)), 2)
    assert emcee_tpu_torch.PTSampler is PTSampler


def test_tempered_model_lifts_unvectorized_functions_over_all_rows():
    """vectorize=False lifts the user functions with torch.func.vmap over
    every rung's rows at once: one call evaluates T * ng walkers."""
    calls = []

    def ll(x):
        calls.append(tuple(x.shape))
        return -0.5 * torch.sum(x**2)

    s = PTSampler(3, 8, 2, ll, lambda x: torch.zeros(()), seed=0,
                  device="cpu", moves=moves.StretchMove(
                      randomize_split=False))
    s.run_mcmc(p0(3, 8), 1)
    assert s.iteration == 1 and len(calls) == 3  # start, two splits


@pytest.mark.parametrize("kw,item", [
    (dict(moves=[moves.StretchMove(), moves.DEMove()]), "P11b"),
    (dict(moves=[(moves.StretchMove(), 0.5)], mixture_block=2), "P11b"),
    (dict(adaptive=True), "P11b"),
    (dict(io_dtype=np.float16), "P11b"),
    (dict(parameter_names=["a", "b"]), "P11b"),
    (dict(moves=moves.EnsembleSliceMove()), "P11b"),
    (dict(moves=moves.ChEESHMCMove(0.5)), "P11b"),
    (dict(pool=object()), "P12"),
    (dict(host_callback=True), "P12"),
    (dict(host_callback_blobs="auto"), "P12"),
    (dict(mesh=object()), "P13"),
    (dict(temp_axis="t"), "P13"),
    (dict(param_axis="p"), "P13"),
])
def test_refusals_name_their_roadmap_item(kw, item):
    """What P12 and P13 port is refused, naming the item; what P11b
    ported (the cases named P11b) constructs and runs."""
    if item == "P11b":
        if "parameter_names" in kw:
            s = PTSampler(4, 16, 2, lambda p: -0.5 * (p["a"]**2 + p["b"]**2),
                          lambda p: torch.zeros(()), seed=3, device="cpu",
                          **kw)
        else:
            s = pt(**kw)
        s.run_mcmc(p0(), 2)
        assert s.iteration == 2
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        pt(**kw)


def test_run_time_refusals_name_their_roadmap_item(tmp_path):
    """Progress bars are refused naming P12; what P11b ported (user blobs,
    ``PTHDFBackend``, ``run_until_converged`` on the cold rung) runs."""
    from emcee_tpu_torch import run_until_converged
    from emcee_tpu_torch.backends import PTHDFBackend

    with pytest.raises(NotImplementedError, match="ROADMAP P12"):
        pt().run_mcmc(p0(), 2, progress=True)
    s = PTSampler(4, 16, 2, lambda x: (-0.5 * (x**2).sum(), x[0]), lp_box,
                  device="cpu")
    s.run_mcmc(p0(), 2)
    np.testing.assert_array_equal(s.get_blobs(), s.get_chain()[..., 0])
    h = PTHDFBackend(str(tmp_path / "chain.h5"))
    pt(backend=h).run_mcmc(p0(), 2)
    assert h.iteration == 2
    s = pt()
    _, mon = run_until_converged(s, p0(), max_steps=10, check_every=5)
    assert s.iteration == 10 and mon.tau.shape == (2,)


def test_entry_points_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU contract is not testable")
    with pytest.raises(RuntimeError, match="CUDA"):
        PTSampler(2, 8, 2, ll_bimodal, lp_box)


def test_pickled_sampler_continues_the_chain():
    import pickle

    s = PTSampler(3, 8, 2, ll_batch, lp_batch, vectorize=True, seed=2,
                  device="cpu")
    s.run_mcmc(p0(3, 8) * 0.5, 5)
    clone = pickle.loads(pickle.dumps(s))
    s.run_mcmc(None, 5)
    clone.run_mcmc(None, 5)
    assert_same_run(s, clone)


# -- statistical twins of tests/unit/test_tempering.py ------------------------

def test_bimodal_mode_hopping():
    """The twin of test_tempering.py:41: without swaps each walker stays
    in its mode; with them the cold rung holds both equally."""
    T, nw, nd = 8, 32, 1
    s = PTSampler(T, nw, nd, ll_bimodal, lp_box, seed=0, device="cpu")
    coords = np.random.default_rng(1).uniform(-10, 10, size=(T, nw, nd))
    s.run_mcmc(coords, 2000)
    chain0 = s.get_chain(temp=0, discard=500, flat=True)
    assert abs((chain0 > 0).mean() - 0.5) < 0.1
    assert abs(np.abs(chain0).mean() - 5.0) < 0.2
    tswap = s.tswap_acceptance_fraction
    assert np.all(tswap > 0.2) and np.all(tswap <= 1.0)


@pytest.mark.slow
def test_single_temperature_matches_plain_sampling():
    """The twin of test_tempering.py:81."""
    nw, nd = 32, 2
    s = PTSampler(1, nw, nd, lambda x: -0.5 * torch.sum(x**2),
                  lambda x: torch.zeros(()), betas=[1.0], seed=3,
                  device="cpu")
    s.run_mcmc(np.random.default_rng(2).normal(size=(1, nw, nd)), 2000)
    chain = s.get_chain(temp=0, discard=500, flat=True)
    assert np.all(np.abs(chain.mean(0)) < 0.1)
    assert np.all(np.abs(chain.std(0) - 1) < 0.08)


@pytest.mark.slow
def test_log_evidence_gaussian():
    """The twin of test_tempering.py:128: lnZ of a unit normal with a
    uniform prior on [-10, 10]."""
    nw, nd, T = 32, 1, 12
    s = PTSampler(T, nw, nd, lambda x: -0.5 * torch.sum(x**2),
                  lambda x: torch.where(torch.all(torch.abs(x) < 10.0),
                                        -float(np.log(20.0)), -torch.inf),
                  seed=0, device="cpu")
    s.run_mcmc(np.random.default_rng(1).uniform(-9, 9, size=(T, nw, nd)),
               3000)
    true = np.log(np.sqrt(2 * np.pi) / 20.0)
    lnz = s.log_evidence_estimate(discard=1000)
    assert abs(lnz - true) < 0.25
    lnz_ss = s.log_evidence_estimate(discard=1000, method="stepping-stone")
    assert abs(lnz_ss - true) < 0.25
    lnz2, dlnz = s.log_evidence_estimate(discard=1000, return_error=True)
    assert lnz2 == lnz and 0.0 <= dlnz < 1.0


def per_rung_loop_oracle(mv, steps, ntemps=8, batched=False):
    """test_tempering.py:273's oracle: a smooth bimodal target whose cold
    rung must hold both modes; rung by rung (the private ``_batched``
    switch off), or every rung at once for a ``rung_batched`` move."""

    def log_like(x):
        a = -0.5 * torch.sum((x - 3.0) ** 2)
        b = -0.5 * torch.sum((x + 3.0) ** 2)
        return torch.logaddexp(a, b)

    def log_prior(x):
        return -0.5 * torch.sum(x**2) / 100.0

    s = PTSampler(ntemps, 32, 1, log_like, log_prior, seed=0, moves=mv,
                  device="cpu")
    s._batched = batched
    if batched:  # every rung at once
        assert getattr(mv, "rung_batched", False)
    s.run_mcmc(np.random.default_rng(0).normal(size=(ntemps, 32, 1)),
               steps)
    cold = s.get_chain(temp=0, flat=True, discard=steps // 5)
    frac_pos = float(np.mean(cold > 0))
    assert 0.25 < frac_pos < 0.75, (type(mv).__name__, frac_pos)
    return s


@pytest.mark.parametrize("batched", [True, False])
def test_pt_with_de_move_per_rung(batched):
    """DEMove on every rung at once (K5a's rung axis) and, under the
    private ``_batched=False`` switch, rung by rung."""
    s = per_rung_loop_oracle(moves.DEMove(), 500, ntemps=4, batched=batched)
    if not batched:  # the per-rung loop
        assert not s._program.batched
    assert np.all(s.acceptance_fraction > 0)


@pytest.mark.slow
def test_pt_with_gradient_move():
    """The twin of test_tempering.py:273: ``MALAMove(0.8)`` and
    ``EnsembleMALAMove(0.8)``, each on every rung at once (K11-K13's rung
    axis)."""
    for mv in (moves.MALAMove(0.8), moves.EnsembleMALAMove(0.8)):
        per_rung_loop_oracle(mv, 1500, batched=True)
