"""Move mixtures, ``mixture_block`` and the looped moves on every rung of
the port's PTSampler.

Exact within the port, bit for bit: a mixture of the stretch move and DE
(both every rung at once) against the forced per-rung loop; a
1-rung ladder at ``beta = 1`` with a mixture and blobs, and with
``EnsembleSliceMove``, against ``EnsembleSampler`` of the same moves and
seed; and the chunk program's replays (graphs stood in for by the
functions they record) against the eager loop, for the mixture with
blobs, ``mixture_block`` 1 and 4 and the adaptive ladder, and for the
slice and ChEES-HMC moves on every rung at once (one read a loop block
or a proposal serving every rung).  Then the twins of ``tests/unit/test_tempering.py:99``
(``test_move_mixture``) and ``tests/unit/test_pt_parity.py:187``
(``test_pt_mixture_block``: the swap counts proposed against
``_count_proposed_delta`` and the cold rung's moments).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu_torch import EnsembleSampler, PTSampler, moves
from emcee_tpu_torch.chunk_graph import ChunkProgram
from emcee_tpu_torch.parallel import default_beta_ladder


def ll_blobs(x):  # tests/unit/test_pt_parity.py:218-220
    ll = -0.5 * torch.sum(x**2)
    return ll, 2.0 * ll, x


def ll_batch(x):
    ll = -0.5 * (x**2).sum(-1)
    return ll, 2.0 * ll, x


def lp_box(x):
    return torch.where(torch.all(torch.abs(x) < 20.0), 0.0, -torch.inf)


def mix():
    return [(moves.StretchMove(), 0.7), (moves.DEMove(), 0.3)]


def p0(T=4, nw=16, nd=2, seed=1):
    return np.random.default_rng(seed).normal(size=(T, nw, nd))


def run_end(s):
    blobs = s.get_blobs()
    return (s.get_chain(), s.get_log_like(), s.get_log_prior(),
            np.asarray(blobs[0]), np.asarray(blobs[1]), s.backend.accepted,
            s.swaps_accepted, s.swaps_proposed, s.betas,
            s.backend.random_state)


def assert_same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_batched_mixture_equals_the_per_rung_loop():
    ends = []
    for batched in (True, False):
        s = PTSampler(3, 12, 2, ll_blobs, lp_box, moves=mix(), seed=5,
                      device="cpu")
        s._batched = batched
        s.run_mcmc(p0(3, 12), 10, thin_by=2)
        s.run_mcmc(None, 6)
        ends.append(run_end(s))
    assert_same(*ends)


@pytest.mark.parametrize("mv", [
    lambda: [(moves.StretchMove(), 0.6), (moves.DEMove(), 0.4)],
    lambda: moves.EnsembleSliceMove(),
])
def test_one_rung_at_beta_one_is_the_ensemble_sampler(mv):
    """A 1-rung ladder at beta = 1 with blobs draws what EnsembleSampler
    draws for the same moves and seed: the same chain and blobs."""
    nw, nd = 16, 3
    start = np.random.default_rng(0).normal(size=(1, nw, nd))
    s = PTSampler(1, nw, nd, ll_batch, lambda x: torch.zeros(x.shape[0]),
                  betas=[1.0], vectorize=True, seed=7, device="cpu",
                  moves=mv(), mixture_block=2)
    s.run_mcmc(start, 12)
    e = EnsembleSampler(nw, nd, ll_batch, vectorize=True, seed=7,
                        device="cpu", moves=mv(), mixture_block=2,
                        blobs_dtype=[("a", np.float32),
                                     ("x", np.float32, (nd,))])
    e.run_mcmc(start[0], 12)
    np.testing.assert_array_equal(s.get_chain(temp=0), e.get_chain())
    np.testing.assert_array_equal(s.get_log_like()[:, 0], e.get_log_prob())
    b, eb = s.get_blobs(temp=0), e.get_blobs()
    np.testing.assert_array_equal(b[0], eb["a"])
    np.testing.assert_array_equal(b[1], eb["x"])
    np.testing.assert_array_equal(s.backend.accepted[0], e.backend.accepted)
    assert s.backend.random_state == e.backend.random_state


class FakeGraph:
    """Stands in for a recorded CUDA graph on the CPU: a replay runs the
    function it was recorded from."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


@pytest.fixture
def fake_graphs(monkeypatch):
    recorded = []

    def capture(self, fn, what):
        recorded.append(what)
        return FakeGraph(fn)

    def warm_up(self, i, tune):
        self.program(self.ws.clone(), i, 1, tune)

    monkeypatch.setattr(ChunkProgram, "_capture", capture)
    monkeypatch.setattr(ChunkProgram, "_warm_up", warm_up)
    return recorded


@pytest.mark.parametrize("blk", [1, 4])
def test_replays_equal_the_eager_loop_with_mixture_blobs_adaptive(
        fake_graphs, blk):
    """The graph path's chain (each run of equal moves replayed, the
    ladder adapted between chunks of 4 kept steps) equals the eager
    loop's: coords, logL, logP, blobs, acceptance, swap counts, ladder,
    offset."""
    step_bytes = 4 * 16 * (2 * 4 + 3 * 4 + 4 + 2 * 4)
    ends = []
    for graphs in (False, True):
        s = PTSampler(4, 16, 2, ll_blobs, lp_box, moves=mix(), seed=9,
                      device="cpu", adaptive=True, mixture_block=blk,
                      adaptation_lag=50, adaptation_time=5,
                      io_chunk_bytes=4 * step_bytes)
        s._use_graphs = graphs
        s.run_mcmc(p0(), 8, thin_by=2)
        s.run_mcmc(None, 12, store=False)
        s.run_mcmc(None, 8)
        ends.append(run_end(s))
    assert_same(*ends)
    assert not np.array_equal(ends[0][8], default_beta_ladder(4, 2))
    assert any("tempered proposals of StretchMove" in w for w in fake_graphs)
    assert any("tempered proposals of DEMove" in w for w in fake_graphs)


@pytest.mark.parametrize("make", [
    lambda: moves.EnsembleSliceMove(tune_mu=True),
    lambda: moves.ChEESHMCMove(0.5),
])
def test_looped_moves_on_every_rung_replay_as_the_eager_loop(
        fake_graphs, make):
    """A looped move on every rung: the slice move's and ChEES's segments
    and loops are replays of graphs of every rung at once, one read of the
    lists' lengths a block (the slice move) or of the largest trip count a
    proposal (ChEES) serving every rung, and no graph is a rung's own.
    Then one segment tunes, swaps and advances; the chain equals the eager
    loop's."""
    T = 3
    ends, reads = [], []
    for graphs in (False, True):
        s = PTSampler(T, 12, 2, ll_blobs, lp_box, moves=make(), seed=11,
                      device="cpu")
        s._use_graphs = graphs
        r0 = ChunkProgram.flag_reads
        s.run_mcmc(p0(T, 12), 4, tune=True)
        s.run_mcmc(None, 4)
        reads.append(ChunkProgram.flag_reads - r0)
        ends.append(run_end(s) + (s._move_carries,))
    assert_same(ends[0][:-1], ends[1][:-1])
    for k, v in ends[0][-1][0].items():
        assert torch.equal(v, ends[1][-1][0][k]), k
    assert reads[0] == 0
    assert s._moves[0].rung_batched
    if isinstance(s._moves[0], moves.EnsembleSliceMove):
        # 8 proposals of 2 splits, each a stepping-out and a shrink loop
        # of one read a block at least, for every rung at once.
        assert reads[1] >= 8 * 2 * 2
    else:
        # One read of the largest trip count a proposal for every rung.
        assert reads[1] == 8
    assert not any("('rung'," in w for w in fake_graphs)
    assert any(k[1] == "tune, swap and advance" for k in s._program.graphs)


def ll_bimodal(x):  # tests/unit/test_tempering.py:23-26
    a = -0.5 * torch.sum((x - 5.0) ** 2)
    b = -0.5 * torch.sum((x + 5.0) ** 2)
    return torch.logaddexp(a, b)


def test_move_mixture():
    """The twin of test_tempering.py:99."""
    T, nw, nd = 4, 16, 2
    s = PTSampler(T, nw, nd, ll_bimodal, lp_box, moves=mix(), seed=0,
                  device="cpu")
    s.run_mcmc(np.random.default_rng(0).normal(size=(T, nw, nd)), 30)
    assert s.get_chain().shape == (30, T, nw, nd)


def test_pt_mixture_block():
    """The twin of test_pt_parity.py:187: blocked mixtures sample
    correctly and keep the swap machinery (parity, counters) continuous
    across blocks."""
    s = PTSampler(4, 32, 2, lambda x: -0.5 * torch.sum(x**2), lp_box,
                  moves=mix(), mixture_block=4, seed=0, device="cpu")
    s.run_mcmc(p0(4, 32, 2), 400)
    assert s.get_chain().shape == (400, 4, 32, 2)
    assert np.all(s.swaps_proposed > 0)
    np.testing.assert_array_equal(s.swaps_proposed,
                                  s._count_proposed_delta(0, 400))
    cold = s.get_chain(temp=0, discard=100, flat=True)
    assert np.all(np.abs(cold.mean(axis=0)) < 0.3)
    assert np.all(np.abs(cold.var(axis=0) - 1.0) < 0.35)
