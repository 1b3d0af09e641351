"""The port's ensemble slice move against the JAX package.

The slice loops are the JAX ``while_loop``s with masked iterations: the
same proposal run with the eager loop (one iteration a check) and with
blocks of B masked iterations a check gives the same state, carry and
counts bit for bit for several B, and the chunk program's block replays
(here with a stand-in for the CUDA graphs) the same chain as the eager
loop.  Every walker that lands lies inside its slice, whose level reads
K2's accept uniform; the caps hold; the ``tune_mu`` fold and tune equal
JAX's on the same statistics (to float32 rounding, rtol 1e-6).  Then the
statistical oracles of ``tests/integration/test_slice.py`` (one in the
fast tier).
"""

import numpy as np
import pytest
import torch
from scipy import stats

torch.set_num_threads(1)

from emcee_tpu import moves as jmoves
from emcee_tpu.model import Model as JModel

import emcee_tpu_torch
from emcee_tpu_torch import convert, moves
from emcee_tpu_torch.chunk_graph import ChunkProgram, EagerLoops
from emcee_tpu_torch.model import Model, wrap_log_prob_fn
from emcee_tpu_torch.ops.philox import SHRINK_MAX, to_uniform, walker_words
from emcee_tpu_torch.state import State

NW, ND = 40, 3


def lp_batch(x):
    return -0.5 * (x**2).sum(-1)


def lp_blobs(x):
    return -0.5 * (x**2).sum(-1), x.sum(-1)


def model(fn=lp_batch, nw=NW):
    return Model(wrap_log_prob_fn(fn, vectorize=True), nw, ND)


def normal_oracle(proposal, ndim=1, nwalkers=32, nsteps=2000, seed=1234,
                  check_acceptance=True, blobs=False):
    """``tests/integration/test_proposal.py``'s ``_test_normal`` on the
    port, with its ``check_acceptance`` and ``blobs`` options (a
    rejection-free move violates the Metropolis acceptance window)."""
    coords = np.random.default_rng(seed).normal(size=(nwalkers, ndim))
    sampler = emcee_tpu_torch.EnsembleSampler(
        nwalkers, ndim, lp_blobs if blobs else lp_batch, vectorize=True,
        moves=proposal, seed=seed, device="cpu")
    sampler.run_mcmc(coords, nsteps)
    if check_acceptance:
        acc = sampler.acceptance_fraction
        assert np.all((acc < 0.9) * (acc > 0.1)), f"acceptance {acc}"
    samps = sampler.get_chain(flat=True)
    mu, sig = np.mean(samps, axis=0), np.std(samps, axis=0)
    assert np.all(np.abs(mu) < 0.08), f"Incorrect mean: {mu}"
    assert np.all(np.abs(sig - 1) < 0.05), f"Incorrect standard deviation: {sig}"
    if ndim == 1:
        ks, _ = stats.kstest(samps[:, 0], "norm")
        assert ks < 0.05, "The K-S test failed"
    if blobs:
        np.testing.assert_allclose(sampler.get_blobs(),
                                   sampler.get_chain().sum(-1), atol=1e-5)


def start(fn=lp_batch, seed=0):
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(NW, ND)).astype(np.float32))
    lp, blobs = wrap_log_prob_fn(fn, vectorize=True)(x)
    return State(x, lp, blobs)


def clone(state):
    blobs = None if state.blobs is None else state.blobs.clone()
    return State(state.coords.clone(), state.log_prob.clone(), blobs)


@pytest.mark.parametrize("randomize_split", [False, True])
@pytest.mark.parametrize("fn", [lp_batch, lp_blobs])
def test_block_loops_equal_the_eager_loop(randomize_split, fn):
    """Blocks of B masked iterations a flag check give the eager loop's
    result bit for bit: coords, log-prob, blobs, acceptance, counts, the
    tuned carry and the loop counters the JAX loops would run."""
    ends = []
    for block in (1, 2, 3, 4, 8):
        move = moves.EnsembleSliceMove(randomize_split=randomize_split,
                                       tune_mu=True)
        st = clone(start(fn))
        carry = move.init_carry(NW, ND, device="cpu")
        count = torch.zeros(NW, dtype=torch.int32)
        for off in range(4):
            st, acc, carry = move.propose((7, off), st, model(fn), carry,
                                          count, loops=EagerLoops(block))
            move.tune(carry, st, acc)
        w = next(iter(move._work.values()))
        ends.append((st, acc, count, carry, w.iterations.clone(),
                     w.executed.clone()))
    ref = ends[0]
    for got in ends[1:]:
        assert torch.equal(got[0].coords, ref[0].coords)
        assert torch.equal(got[0].log_prob, ref[0].log_prob)
        if fn is lp_blobs:
            assert torch.equal(got[0].blobs, ref[0].blobs)
        assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
        for k in ref[3]:
            assert torch.equal(got[3][k], ref[3][k]), k
        assert torch.equal(got[4], ref[4])  # the JAX loops' iterations
        assert bool((got[5] >= got[4]).all())  # masked ones run besides
    assert torch.equal(ref[5], ref[4])  # B = 1 runs no masked iteration


def test_landed_walkers_lie_inside_their_slice():
    """Blocked split: the level is ``lp + log U`` with U the accept
    uniform K2 would read (word 1 at ``(walker, split)``), or the
    injected one; every accepted walker's new log-prob is above it and
    is the log-prob of its new coords; a rejected walker stays put."""
    ng = NW // 2
    for inject in (False, True):
        move = moves.EnsembleSliceMove(randomize_split=False, mu=2.0)
        st0 = start(seed=3)
        st = clone(st0)
        seed, off = 5, 11
        if inject:
            log_u = torch.log(torch.rand(2, ng, generator=torch.Generator()
                                         .manual_seed(1)))
        else:
            log_u = torch.stack([torch.log(to_uniform(
                walker_words(ng, s, seed, off, "cpu")[1])) for s in (0, 1)])
        st, acc, _ = move.propose((seed, off), st, model(), (),
                                  log_acc_u=log_u if inject else None)
        y = st0.log_prob + log_u.reshape(-1)
        assert acc.any()
        assert bool((st.log_prob[acc] > y[acc]).all())
        assert torch.equal(st.log_prob, lp_batch(st.coords))
        assert torch.equal(st.coords[~acc], st0.coords[~acc])


def test_caps_bind_and_hold():
    """With ``max_steps=2`` and ``max_shrink=1`` no group runs more
    iterations than its caps, and a walker that hits ``max_shrink``
    stays put and is reported unaccepted."""
    move = moves.EnsembleSliceMove(mu=20.0, max_steps=2, max_shrink=1,
                                   randomize_split=False)
    st0 = start(seed=4)
    st = clone(st0)
    count = torch.zeros(NW, dtype=torch.int32)
    st, acc, _ = move.propose((3, 1), st, model(), (), count)
    w = next(iter(move._work.values()))
    assert int(w.iterations[0]) <= 2 * 2 and int(w.iterations[1]) <= 2
    assert (~acc).any() and acc.any()
    assert torch.equal(st.coords[~acc], st0.coords[~acc])
    assert torch.equal(count, acc.to(torch.int32))


def test_walker_evaluations_are_counted_only_when_asked():
    """``count_evals`` counts what a walker-by-walker loop evaluates: the
    same for every B, within the masked loops' trips, none stepping out
    when ``max_steps=1`` leaves both ends no budget, exactly one a walker
    when ``max_shrink=1``; without it the counter stays 0."""
    got = []
    for block in (1, 4):
        move = moves.EnsembleSliceMove(randomize_split=False)
        move.count_evals = True
        st = clone(start())
        for off in range(3):
            st, acc, _ = move.propose((2, off), st, model(), (),
                                      loops=EagerLoops(block))
        w = next(iter(move._work.values()))
        got.append(w.evals.clone())
        assert int(w.evals[0]) <= 2 * (NW // 2) * int(w.iterations[0])
        assert int(w.evals[1]) <= (NW // 2) * int(w.iterations[1])
        assert int(w.evals[1]) >= int(acc.sum())
        assert int(w.evals[0]) >= 3 * NW  # one end at least has budget
    assert torch.equal(got[0], got[1])
    move = moves.EnsembleSliceMove(max_steps=1, max_shrink=1,
                                   randomize_split=False)
    move.count_evals = True
    move.propose((2, 0), clone(start()), model(), ())
    w = next(iter(move._work.values()))
    assert w.evals.tolist() == [0, NW] and int(w.iterations[0]) == 2
    move = moves.EnsembleSliceMove()
    move.propose((2, 0), clone(start()), model(), ())
    assert next(iter(move._work.values())).evals.tolist() == [0, 0]


def test_fold_and_tune_match_jax():
    """``frac_expand = sum(nexp) / max(sum(nexp) + sum(ncon), 1)`` and the
    Robbins-Monro step of ``log_adj`` toward a balanced fraction, on the
    same per-split statistics."""
    jmove = jmoves.EnsembleSliceMove(tune_mu=True, tune_rate=0.7)
    move = moves.EnsembleSliceMove(tune_mu=True, tune_rate=0.7)
    jcarry = jmove.init_carry(NW, ND)
    carry = move.init_carry(NW, ND, device="cpu")
    jm = JModel(lambda x: (x, None))
    rng = np.random.default_rng(0)
    for _ in range(6):
        stats_ = [tuple(np.float32(v) for v in rng.integers(0, 50, 2))
                  for _ in range(2)]
        jcarry = jmove._fold_split_stats(jcarry, stats_, jm)
        jcarry = jmove.tune(jcarry, None, None)
        move._fold_split_stats(carry, [tuple(torch.tensor(v) for v in s)
                                       for s in stats_], None)
        move.tune(carry, None, None)
        for k, v in jcarry.items():
            np.testing.assert_allclose(carry[k].numpy(), np.asarray(v),
                                       1e-6, 1e-7)
    assert int(carry["t"]) == 6
    # An all-zero split (nothing expanded or contracted) folds to 0.
    move._fold_split_stats(carry, [(torch.tensor(0.0), torch.tensor(0.0))],
                           None)
    assert float(carry["frac_expand"]) == 0.0
    assert moves.EnsembleSliceMove().init_carry(NW, ND) == ()


class FakeGraph:
    """Stands in for a recorded CUDA graph on the CPU: replay runs the
    function it was recorded from."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def test_block_replays_equal_the_eager_loop_in_a_mixture(monkeypatch):
    """The chunk program's looped path (segments and block replays,
    recorded once each) against the eager per-proposal loop, with the
    slice move interleaved with a whole-proposal move."""
    recorded = []

    def capture(self, fn, what):
        recorded.append(what)
        return FakeGraph(fn)

    def warm_up(self, i, tune):
        self.program(self.ws.clone(), i, 1, tune)

    monkeypatch.setattr(ChunkProgram, "_capture", capture)
    monkeypatch.setattr(ChunkProgram, "_warm_up", warm_up)
    p0 = np.random.default_rng(2).normal(size=(NW, ND))
    ends = []
    for graphs in (False, True):
        mix = [(moves.EnsembleSliceMove(tune_mu=True), 0.5),
               (moves.StretchMove(randomize_split=False, pair_mode="roll"),
                0.5)]
        smp = emcee_tpu_torch.EnsembleSampler(NW, ND, lp_blobs,
                                              vectorize=True, moves=mix,
                                              seed=4, device="cpu")
        smp._use_graphs = graphs
        reads = ChunkProgram.flag_reads
        smp.run_mcmc(p0, 30, tune=True)
        smp.run_mcmc(None, 10, thin_by=2)
        ends.append((smp.get_chain(), smp.get_blobs(),
                     smp._previous_state, smp._move_carries,
                     ChunkProgram.flag_reads - reads))
    (c0, b0, s0, k0, r0), (c1, b1, s1, k1, r1) = ends
    assert np.array_equal(c0, c1) and np.array_equal(b0, b1)
    assert torch.equal(s0.coords, s1.coords)
    assert s0.random_state == s1.random_state
    for k in k0[0]:
        assert torch.equal(k0[0][k], k1[0][k]), k
    assert r0 == 0 and r1 > 0
    # each graph recorded once (segments, blocks, whole proposals)
    assert len(recorded) == len(smp._program.graphs)
    assert any("step out" in w for w in recorded)
    with pytest.raises(ValueError, match="block replays"):
        smp._program.graph(0, 1, False)


def test_constructor_matches_jax():
    for kw, match in (({"tune_target": 0.5}, "tune_target"),
                      ({"mu": -1.0}, "mu"), ({"mu": 0.0}, "mu")):
        for mod in (moves, jmoves):
            with pytest.raises(ValueError, match=match):
                mod.EnsembleSliceMove(**kw)
    with pytest.raises(ValueError, match="max_shrink"):
        moves.EnsembleSliceMove(max_shrink=SHRINK_MAX + 1)
    a, b = moves.EnsembleSliceMove(), jmoves.EnsembleSliceMove()
    assert (a.mu, a.max_steps, a.max_shrink, a.tune_mu, a.nsplits) == (
        b.mu, b.max_steps, b.max_shrink, b.tune_mu, b.nsplits)
    assert a.blendable is False and a.looped is True


def test_carry_converts_from_jax():
    jc = jmoves.EnsembleSliceMove(tune_mu=True).init_carry(8, 2)
    jc = {k: np.array(v) for k, v in jc.items()}
    jc["frac_expand"] = np.float32(0.3)
    carry = convert.carry_from_numpy(jc, device="cpu")
    for k, v in jc.items():
        assert carry[k].numpy().dtype == np.asarray(v).dtype
        assert carry[k].numpy() == v


def test_blob_values_track_the_chain():
    """``test_slice.py:101-118``: the landed point's blob rides the
    shrink loop, so every stored blob is the function at the stored
    coords."""
    s = emcee_tpu_torch.EnsembleSampler(16, 2, lp_blobs, vectorize=True,
                                        moves=moves.EnsembleSliceMove(),
                                        seed=0, device="cpu")
    s.run_mcmc(np.random.default_rng(1).normal(size=(16, 2)), 30)
    np.testing.assert_allclose(s.get_blobs(), s.get_chain().sum(-1),
                               atol=1e-5)
    assert s.acceptance_fraction.min() > 0.99


def test_normal_slice():
    """The fast oracle of ``test_slice.py``."""
    normal_oracle(moves.EnsembleSliceMove(), nsteps=2000,
                  check_acceptance=False)


@pytest.mark.slow
def test_normal_slice_3d_blocked():
    normal_oracle(moves.EnsembleSliceMove(randomize_split=False), ndim=3,
                  check_acceptance=False)


@pytest.mark.slow
def test_normal_slice_blobs():
    normal_oracle(moves.EnsembleSliceMove(), nsteps=1500,
                  check_acceptance=False, blobs=True)


@pytest.mark.slow
def test_slice_tune_mu_recovers_bad_scale():
    move = moves.EnsembleSliceMove(mu=0.01, tune_mu=True, tune_rate=1.0)
    s = emcee_tpu_torch.EnsembleSampler(32, 2, lp_batch, vectorize=True,
                                        moves=move, seed=7, device="cpu")
    s.run_mcmc(0.01 * np.random.default_rng(7).normal(size=(32, 2)), 800,
               tune=True)
    chain = s.get_chain(discard=400, flat=True)
    assert abs(chain.mean()) < 0.15 and abs(chain.std() - 1.0) < 0.15


@pytest.mark.slow
def test_slice_tight_budget_heavy_tail_exact():
    def lp_cauchy(x):
        return -torch.log1p(x**2).sum(-1)

    s = emcee_tpu_torch.EnsembleSampler(
        64, 1, lp_cauchy, vectorize=True, seed=2, device="cpu",
        moves=moves.EnsembleSliceMove(max_steps=4))
    p0 = np.random.default_rng(2).standard_cauchy(size=(64, 1)).clip(-50, 50)
    s.run_mcmc(p0, 3000)
    samps = s.get_chain(discard=500, flat=True).ravel()
    assert abs(np.median(samps)) < 0.1
    assert abs((np.abs(samps) > 1.0).mean() - 0.5) < 0.05


@pytest.mark.slow
def test_slice_in_mixture():
    s = emcee_tpu_torch.EnsembleSampler(
        32, 2, lp_batch, vectorize=True, seed=11, device="cpu",
        moves=[(moves.EnsembleSliceMove(), 0.5), (moves.StretchMove(), 0.5)])
    s.run_mcmc(np.random.default_rng(11).normal(size=(32, 2)), 500)
    chain = s.get_chain(discard=200, flat=True)
    assert abs(chain.mean()) < 0.15 and abs(chain.std() - 1.0) < 0.15


@pytest.mark.slow
def test_uniform_slice():
    """A chain sampled from a normal fails a uniform K-S test."""
    s = emcee_tpu_torch.EnsembleSampler(
        32, 1, lp_batch, vectorize=True, seed=1234, device="cpu",
        moves=moves.EnsembleSliceMove())
    s.run_mcmc(np.random.default_rng(1234).uniform(size=(32, 1)), 2000)
    samps = s.get_chain(flat=True)
    np.random.default_rng(1234).shuffle(samps)
    ks, _ = stats.kstest(samps[::100, 0], "uniform")
    assert ks > 0.1
