"""``EnsembleSliceMove`` on every rung of the port's tempered ladder: K9
with the rung axis (``emcee_tpu_torch/ops/slice_kernel.py``) under
``EnsembleSliceMove.propose_rungs`` (``rung_batched``), the counterpart of
the JAX package's ``jax.vmap`` of the move over the rungs, one
``while_loop`` serving every rung (``emcee_tpu/parallel/tempering.py:
449-541``).

Each rung's lists are compacted in its own rows and it draws under its own
key at the one-ensemble counters, so on a ladder the batched ``PTSampler``
equals the forced per-rung loop (the private ``_batched`` switch) bit for
bit: chain, logL, logP, blobs, acceptance, swaps and the tuned carry,
shuffled and blocked, eagerly and by the chunk program's replays (graphs
stood in for by the functions they record).  Then one statistical oracle:
the cold rung of the bimodal target against the JAX ``PTSampler`` with
``EnsembleSliceMove`` from the same start.  JAX runs on the CPU
(tests/conftest.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu import moves as jmoves
from emcee_tpu.parallel.tempering import PTSampler as JPTSampler

from emcee_tpu_torch import PTSampler, moves
from emcee_tpu_torch.chunk_graph import ChunkProgram

T, NW, ND = 4, 24, 2


def ll_blobs(x):  # tests/unit/test_pt_parity.py:218-220
    ll = -0.5 * torch.sum(x**2)
    return ll, 2.0 * ll, x


def ll_bimodal(x):  # tests/unit/test_tempering.py:23-26, vectorized
    a = -0.5 * torch.sum((x - 5.0) ** 2, -1)
    b = -0.5 * torch.sum((x + 5.0) ** 2, -1)
    return torch.logaddexp(a, b)


def lp_box(x):  # tests/unit/test_tempering.py:29-30, vectorized
    return torch.where(torch.all(torch.abs(x) < 20.0, -1), 0.0, -torch.inf)


def j_ll_bimodal(x):
    a = -0.5 * jnp.sum((x - 5.0) ** 2)
    b = -0.5 * jnp.sum((x + 5.0) ** 2)
    return jnp.logaddexp(a, b)


def j_lp_box(x):
    return jnp.where(jnp.all(jnp.abs(x) < 20.0), 0.0, -jnp.inf)


class FakeGraph:
    """Stands in for a recorded CUDA graph on the CPU: a replay runs the
    function it was recorded from."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def fake_graphs(monkeypatch):
    def capture(self, fn, what):
        return FakeGraph(fn)

    def warm_up(self, i, tune):
        self.program(self.ws.clone(), i, 1, tune)

    monkeypatch.setattr(ChunkProgram, "_capture", capture)
    monkeypatch.setattr(ChunkProgram, "_warm_up", warm_up)


def run_end(s):
    blobs = s.get_blobs()
    return (s.get_chain(), s.get_log_like(), s.get_log_prior(),
            np.asarray(blobs[0]), np.asarray(blobs[1]), s.backend.accepted,
            s.swaps_accepted, s.swaps_proposed,
            s._previous_state.coords.numpy())


@pytest.mark.parametrize("graphs", [False, True])
@pytest.mark.parametrize("make", [
    lambda: moves.EnsembleSliceMove(tune_mu=True),
    lambda: moves.EnsembleSliceMove(randomize_split=False, nsplits=3,
                                    max_steps=3, max_shrink=4, mu=4.0),
])
def test_batched_path_equals_the_per_rung_loop(monkeypatch, make, graphs):
    if graphs:
        fake_graphs(monkeypatch)
    ends, reads = [], []
    for batched in (True, False):
        mv = make()
        mv.bucket_floor = 4
        s = PTSampler(T, NW, ND, ll_blobs, lp_box, moves=mv, seed=7,
                      device="cpu")
        s._batched = batched
        s._use_graphs = graphs
        r0 = ChunkProgram.flag_reads
        start = np.random.default_rng(3).normal(size=(T, NW, ND)) * 2.0
        s.run_mcmc(start, 6, thin_by=2, tune=True)
        s.run_mcmc(None, 5)
        reads.append(ChunkProgram.flag_reads - r0)
        assert s._program.batched is batched
        carry = s._move_carries[0]
        ends.append(run_end(s) + ((
            {k: v.clone() for k, v in carry.items()} if carry else {}),))
    for x, y in zip(ends[0][:-1], ends[1][:-1]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    a, b = ends[0][-1], ends[1][-1]
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert a[k].shape == (T,)
    if graphs:
        # One read of the lists' lengths a block serves every rung.
        assert 0 < reads[0] < reads[1]
    assert 0 < ends[0][5].sum() <= T * NW * 17


def test_cold_rung_matches_the_jax_sampler():
    """Both samplers from one start on the bimodal target (modes at +-5):
    the cold rung's mode fraction, mean ``|x|`` and its spread agree with
    the JAX ``PTSampler``'s within Monte Carlo windows, and each holds
    both modes."""
    nsteps, discard = 150, 40
    start = np.random.default_rng(1).uniform(-8, 8, size=(T, 16, 1))
    port = PTSampler(T, 16, 1, ll_bimodal, lp_box, seed=0, device="cpu",
                     moves=moves.EnsembleSliceMove(), vectorize=True)
    port.run_mcmc(start, nsteps)
    jpt = JPTSampler(T, 16, 1, j_ll_bimodal, j_lp_box, seed=0,
                     moves=jmoves.EnsembleSliceMove())
    jpt.run_mcmc(start.astype(np.float32), nsteps)
    stats = []
    for s in (port, jpt):
        x = np.asarray(s.get_chain(temp=0, discard=discard, flat=True))
        assert np.all(np.isfinite(x))
        stats.append(((x > 0).mean(), np.abs(x).mean(), np.abs(x).std()))
    (fp, mp, sp), (fj, mj, sj) = stats
    for frac in (fp, fj):
        assert 0.25 < frac < 0.75, stats
    assert abs(fp - fj) < 0.25, stats
    assert abs(mp - 5.0) < 0.2 and abs(mj - 5.0) < 0.2, stats
    assert abs(mp - mj) < 0.15, stats
    assert abs(sp - sj) < 0.15 and abs(sp - 1.0) < 0.15, stats
    assert np.all(port.tswap_acceptance_fraction > 0.2)
    assert np.all(port.acceptance_fraction > 0.99)
