"""K3, the chunk program (``emcee_tpu_torch/chunk_graph.py``), on the CPU.

* The per-proposal function that a CUDA graph records, run eagerly here,
  gives the same chain, bit for bit, as the per-proposal loop the sampler
  ran before the chunk program existed (frozen below as the reference):
  blocked and shuffled splits, both pair modes, DE, snooker, a weighted
  mixture with ``mixture_block`` 1 and 4 (with a ragged tail chunk),
  ``tune=True``, ``store=False``, ``Backend``, ``DeviceBackend`` and
  ``sample()``;
* the device-offset Philox (a 0-d int64 word plus an increment) draws
  what the host-offset Philox draws: ``walker_words``, the K5a roll
  shifts, the K5b roll picks and every plain kernel version;
* ``driver.move_sequence`` and ``chunk_replays`` reproduce
  ``choose_move``'s sequence; replaying cached "graphs" (a fake that runs
  the recorded program) equals the eager loop and records once per key;
* one proposal of the chunk program equals the JAX step with the port's
  own uniforms injected, to the tolerances of ``test_torch_moves.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu.model import Model as JModel
from emcee_tpu.moves import StretchMove as JStretchMove
from emcee_tpu.state import State as JState

import emcee_tpu_torch
from emcee_tpu_torch import chunk_graph, moves
from emcee_tpu_torch.backends import DeviceBackend
from emcee_tpu_torch.chunk_graph import ChunkProgram, graph_sizes
from emcee_tpu_torch.driver import (
    choose_move, chunk_replays, chunk_schedule, move_sequence)
from emcee_tpu_torch.model import Model, wrap_log_prob_fn
from emcee_tpu_torch.ops import (
    accept_kernel, de_kernel, philox, snooker_kernel, stretch_kernel)
from emcee_tpu_torch.ops.philox import DeviceOffset
from emcee_tpu_torch.state import State

RTOL, ATOL = 1e-5, 1e-6  # test_torch_moves.py


def lp_batch(x):
    return -0.5 * (x**2).sum(-1)


def pr2_chunk(moves_, weights, blk, model, state, carries, nkeep, thin_by,
              tune, acc_count):
    """Frozen copy of the sampler's chunk loop before the chunk program:
    one ``move.propose`` per proposal with the host offset, the move
    choice per proposal or per ``mixture_block`` block, carries threaded
    through; returns the state, carries and each kept step's rows."""
    seed, offset = state.random_state
    blocked = len(moves_) > 1 and blk > 1 and nkeep % blk == 0
    rows = []
    for k in range(nkeep):
        if blocked and k % blk == 0:
            i_blk = choose_move(weights, seed, offset, block=True)
        for _ in range(thin_by):
            i = i_blk if blocked else choose_move(weights, seed, offset)
            move = moves_[i]
            state, accepted, c = move.propose(
                (seed, offset), state, model, carries[i], acc_count)
            if tune:
                c = move.tune(c, state, accepted, model)
            carries = carries[:i] + (c,) + carries[i + 1:]
            offset += 1
        rows.append((state.coords.clone(), state.log_prob.clone(),
                     accepted.clone()))
    return state._replace(random_state=(seed, offset)), carries, rows


def pr2_run(smp, p0, nsteps, thin_by, tune, max_chunk):
    """The frozen loop over the sampler's own chunk schedule, from a fresh
    copy of its moves' carries."""
    coords = torch.as_tensor(np.asarray(p0, np.float64), dtype=torch.float32)
    state = State(coords.clone(), lp_batch(coords), None, (smp._rng[0], 0))
    carries = tuple(m.init_carry(smp.nwalkers, smp.ndim) for m in smp._moves)
    blk = smp._mixture_block if len(smp._moves) > 1 else 1
    count = torch.zeros(smp.nwalkers, dtype=torch.int32)
    rows = []
    for n in chunk_schedule(nsteps, max_chunk, blk):
        state, carries, r = pr2_chunk(
            smp._moves, smp._weights, smp._mixture_block, smp._model, state,
            carries, n, thin_by, tune, count)
        rows += r
    return state, carries, count, rows


def mixture():
    return [(moves.DEMove(pair_mode="roll", randomize_split=False), 0.8),
            (moves.DESnookerMove(pair_mode="roll", nsplits=2,
                                 randomize_split=False), 0.2)]


CASES = {
    "stretch-blocked-roll": dict(
        mv=lambda: moves.StretchMove(randomize_split=False, pair_mode="roll")),
    "stretch-blocked-random": dict(
        mv=lambda: moves.StretchMove(randomize_split=False)),
    "stretch-shuffled-roll": dict(
        mv=lambda: moves.StretchMove(pair_mode="roll")),
    "stretch-shuffled-random": dict(mv=lambda: moves.StretchMove()),
    "de-roll-blocked": dict(
        mv=lambda: moves.DEMove(pair_mode="roll", randomize_split=False)),
    "de-random-shuffled": dict(mv=lambda: moves.DEMove(sigma=0.2)),
    "snooker-roll-2": dict(
        mv=lambda: moves.DESnookerMove(pair_mode="roll", nsplits=2,
                                       randomize_split=False)),
    "snooker-random-4": dict(mv=lambda: moves.DESnookerMove()),
    "mixture-block1": dict(mv=mixture),
    "mixture-block4-ragged": dict(mv=mixture, mixture_block=4, nsteps=42,
                                  max_chunk_steps=8),
    "tune-stretch": dict(
        mv=lambda: moves.StretchMove(randomize_split=False, pair_mode="roll",
                                     tune_target=0.3), tune=True),
    "tune-mixture": dict(
        mv=lambda: [(moves.DEMove(tune_target=0.25), 0.5),
                    (moves.StretchMove(tune_target=0.4), 0.5)], tune=True),
    "thin3-backend": dict(
        mv=lambda: moves.StretchMove(randomize_split=False, pair_mode="roll"),
        nsteps=40, thin_by=3),
    "thin3-device-backend": dict(
        mv=lambda: moves.StretchMove(), nsteps=40, thin_by=3,
        backend=DeviceBackend, max_chunk_steps=7),
    "store-false": dict(mv=mixture, store=False, mixture_block=4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_chunk_program_equals_the_per_proposal_loop(name):
    case = dict(CASES[name])
    nw, nd = 32, 4
    nsteps = case.pop("nsteps", 60)
    thin_by = case.pop("thin_by", 1)
    tune = case.pop("tune", False)
    store = case.pop("store", True)
    backend = case.pop("backend", None)
    p0 = np.random.default_rng(7).normal(size=(nw, nd))
    smp = emcee_tpu_torch.EnsembleSampler(
        nw, nd, lp_batch, vectorize=True, moves=case.pop("mv")(), seed=11,
        device="cpu", backend=None if backend is None else backend(), **case)
    end = smp.run_mcmc(p0, nsteps, thin_by=thin_by, tune=tune, store=store)
    max_chunk = smp._auto_chunk(store)
    ref, carries, count, rows = pr2_run(smp, p0, nsteps, thin_by, tune,
                                        max_chunk)
    assert torch.equal(end.coords, ref.coords)
    assert torch.equal(end.log_prob, ref.log_prob)
    assert end.random_state == ref.random_state == (11, nsteps * thin_by)
    assert torch.equal(smp.last_run_stats.accepted, count)
    for mine, theirs in zip(smp._move_carries, carries):
        if isinstance(theirs, dict):
            assert all(torch.equal(mine[k], theirs[k]) for k in theirs)
    if store:
        np.testing.assert_array_equal(
            smp.get_chain(), np.stack([r[0].numpy() for r in rows]))
        np.testing.assert_array_equal(
            smp.get_log_prob(), np.stack([r[1].numpy() for r in rows]))
        np.testing.assert_array_equal(
            smp.backend.accepted,
            np.stack([r[2].numpy() for r in rows]).sum(0))
    else:
        assert smp.iteration == 0


def test_sample_generator_equals_the_per_proposal_loop():
    nw, nd, n, thin_by = 32, 3, 12, 2
    p0 = np.random.default_rng(3).normal(size=(nw, nd))
    smp = emcee_tpu_torch.EnsembleSampler(
        nw, nd, lp_batch, vectorize=True, moves=mixture(), seed=5,
        device="cpu")
    got = [(st.coords, st.log_prob, st.random_state)
           for st in smp.sample(p0, iterations=n, thin_by=thin_by)]
    _, _, _, rows = pr2_run(smp, p0, n, thin_by, False, 1)
    assert [rs for _, _, rs in got] == [(5, thin_by * (k + 1))
                                        for k in range(n)]
    for (c, lp, _), (rc, rlp, _) in zip(got, rows):
        assert torch.equal(c, rc) and torch.equal(lp, rlp)
    np.testing.assert_array_equal(smp.get_chain(),
                                  np.stack([r[0].numpy() for r in rows]))


def dev_offset(offset, inc):
    """``offset`` as a device word ``offset - inc`` plus ``inc``."""
    return DeviceOffset(torch.tensor(offset - inc, dtype=torch.int64), inc)


OFFSETS = [(0, 0), (5, 3), (2**32 + 17, 1), (2**33 - 1, 63)]


@pytest.mark.parametrize("offset,inc", OFFSETS)
def test_device_offset_walker_words_equal_host_offset(offset, inc):
    seed = 0xDEADBEEF12345
    for split in (0, 3, philox.PAIR_BLOCK | 1):
        host = philox.walker_words(40, split, seed, offset, "cpu")
        dev = philox.walker_words(40, split, seed, dev_offset(offset, inc),
                                  "cpu")
        assert all(torch.equal(a, b) for a, b in zip(host, dev))
        lo, hi = philox.split_offset(offset)
        for i in (0, 39):
            assert [int(w[i]) for w in dev] == philox.philox4x32_scalar(
                (i, split, lo, hi), philox.split_key(seed))


def f32(x):
    return np.float32(x)


@pytest.mark.parametrize("offset,inc", OFFSETS)
def test_device_offset_roll_draws_equal_host_draws(offset, inc):
    """The roll uniforms, the K1 shift, the K5a shifts and the K5b picks
    from the device word equal the host Philox and numpy float32
    arithmetic of the same counter."""
    seed = 987654321
    for split, nc, ng in ((0, 37, 12), (1, 50_000, 25_000), (3, 9, 3)):
        u = philox.uniforms_scalar(seed, philox.ROLL_LANE, split, offset)
        ud = philox.roll_uniforms(seed, split, dev_offset(offset, inc), "cpu")
        assert ud.tolist() == u
        shift = philox.roll_shift(seed, split, dev_offset(offset, inc), nc)
        assert int(shift) == int(f32(u[0]) * f32(nc))
        s1, s2 = de_kernel.de_roll_shifts(ud[0], ud[1], nc)
        h1 = int(f32(u[0]) * f32(nc)) % nc
        h2 = (h1 + 1 + int(f32(u[1]) * f32(nc - 1))) % nc
        assert (int(s1), int(s2)) == (h1, h2)
        for nsplits in (2, 4):
            if split >= nsplits:
                continue
            groups, shifts = snooker_kernel.roll_picks(ud, split, nsplits, ng)
            picks = [(k % (nsplits - 1) + (k % (nsplits - 1) >= split),
                      int(f32(u[1 + k]) * f32(ng))) for k in range(3)]
            if nsplits == 4:
                p = min(int(f32(u[0]) * f32(6)), 5)
                picks = [picks[k] for k in snooker_kernel.PERMS3[p]]
            assert list(zip(groups.tolist(), shifts.tolist())) == picks


@pytest.mark.parametrize("pair_mode", ["roll", "random"])
def test_plain_kernels_draw_the_same_from_a_device_offset(pair_mode):
    rng = np.random.default_rng(4)
    nw, nd, seed = 48, 4, 31
    coords = torch.from_numpy(rng.normal(size=(nw, nd)).astype(np.float32))
    lp = lp_batch(coords)
    for offset, inc in OFFSETS:
        off = dev_offset(offset, inc)
        for split in (0, 1):
            for fn, kw in (
                    (stretch_kernel.stretch_propose_plain,
                     dict(a=2.0, ndim_global=nd)),
                    (de_kernel.de_propose_plain,
                     dict(gamma0=0.5, sigma=0.1)),
                    (snooker_kernel.snooker_propose_plain,
                     dict(gammas=1.7, ndim_global=nd))):
                ns = 4 if (fn is snooker_kernel.snooker_propose_plain
                           and pair_mode == "random") else 2
                a = fn(coords, split, ns, pair_mode=pair_mode, seed=seed,
                       offset=offset, **kw)
                b = fn(coords, split, ns, pair_mode=pair_mode, seed=seed,
                       offset=off, **kw)
                assert all(torch.equal(x, y) for x, y in zip(a, b)), fn
            q, f = a
            outs = []
            for o in (offset, off):
                c, l = coords.clone(), lp.clone()
                acc = torch.zeros(nw, dtype=torch.bool)
                cnt = torch.zeros(nw, dtype=torch.int32)
                accept_kernel.accept_select_plain(
                    q, f, lp_batch(q), c, l, split, 4 if ns == 4 else 2, acc,
                    cnt, seed=seed, offset=o)
                outs.append((c, l, acc, cnt))
            assert all(torch.equal(x, y) for x, y in zip(*outs))


@pytest.mark.parametrize("blk,nkeep", [(1, 10), (4, 12), (4, 10), (3, 7)])
@pytest.mark.parametrize("thin_by", [1, 3])
def test_move_sequence_reproduces_choose_move(blk, nkeep, thin_by):
    weights = np.array([0.8, 0.2])
    seed, offset = 9, 1000
    seq = move_sequence(weights, seed, offset, nkeep, thin_by, blk)
    want = []
    blocked = blk > 1 and nkeep % blk == 0
    for k in range(nkeep):
        for t in range(thin_by):
            p = offset + k * thin_by + t
            if blocked:
                want.append(choose_move(weights, seed,
                                        offset + (k // blk) * blk * thin_by,
                                        block=True))
            else:
                want.append(choose_move(weights, seed, p))
    assert seq.tolist() == want
    assert move_sequence(np.array([1.0]), seed, offset, nkeep, thin_by,
                         blk).tolist() == [0] * (nkeep * thin_by)
    for cut in (None, thin_by):
        runs = chunk_replays(seq, cut)
        assert [i for i, n in runs for _ in range(n)] == want
        ends = np.cumsum([n for _, n in runs])
        if cut is not None:
            # every run lies inside one kept step
            starts = ends - [n for _, n in runs]
            assert all(s // cut == (e - 1) // cut
                       for s, e in zip(starts, ends))
        else:
            assert all(a != b for (a, _), (b, _) in zip(runs, runs[1:]))


def test_graph_sizes():
    for n in range(0, 300):
        sizes = graph_sizes(n)
        assert sum(sizes) == n
        assert all(s & (s - 1) == 0 and s <= chunk_graph.MAX_GRAPH
                   for s in sizes)
        assert sizes == sorted(sizes, reverse=True)
        assert len(set(sizes) - {chunk_graph.MAX_GRAPH}) == len(
            [s for s in sizes if s != chunk_graph.MAX_GRAPH])


class FakeGraph:
    """Stands in for a recorded CUDA graph on the CPU: replay runs the
    program it was recorded with."""

    def __init__(self, prog, i, n, tune):
        self.run = lambda: prog.program(prog.ws, i, n, tune)

    def replay(self):
        self.run()


def test_replays_equal_the_eager_loop_and_record_once_per_key(monkeypatch):
    recorded = []

    def fake_record(self, i, n, tune):
        recorded.append((i, n, tune))
        return FakeGraph(self, i, n, tune)

    monkeypatch.setattr(ChunkProgram, "_record", fake_record)
    nw, nd = 32, 3
    p0 = np.random.default_rng(2).normal(size=(nw, nd))
    runs = []
    for graphs in (False, True):
        smp = emcee_tpu_torch.EnsembleSampler(
            nw, nd, lp_batch, vectorize=True, moves=mixture(),
            mixture_block=2, seed=8, device="cpu", max_chunk_steps=30)
        smp._use_graphs = graphs
        before = ChunkProgram.replays
        smp.run_mcmc(p0, 100, store=False)
        smp.run_mcmc(None, 10, thin_by=5)
        runs.append((smp.get_chain(), smp._previous_state.coords,
                     ChunkProgram.replays - before))
    assert np.array_equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert runs[0][2] == 0 and runs[1][2] > 0
    # recorded once per (move, proposals, tune), across chunks and runs
    assert len(recorded) == len(set(recorded))
    assert {n for _, n, _ in recorded} <= {1, 2, 4, 8, 16, 32, 64}
    # a new seed gets a new program, the same seed keeps its graphs
    prog = smp._program
    smp.run_mcmc(None, 4, thin_by=5)
    assert smp._program is prog
    smp.random_state = (9, 0)
    smp.run_mcmc(None, 2)
    assert smp._program is not prog and smp._program.seed == 9


@pytest.mark.parametrize("scale", [None, 1.3])
def test_one_proposal_of_the_program_matches_jax(scale):
    """The chunk program's proposal on the CPU draws its uniforms from the
    device-offset Philox; the same uniforms, injected into the JAX
    package's blocked stretch step, give the same next state."""
    rng = np.random.default_rng(5)
    nw, nd, ns, seed, offset = 32, 3, 2, 21, 2**32 + 3
    ng = nw // ns
    coords = torch.from_numpy(rng.normal(size=(nw, nd)).astype(np.float32))
    lp = lp_batch(coords)
    move = moves.StretchMove(randomize_split=False, pair_mode="roll",
                             tune_target=None if scale is None else 0.3)
    carry = move.init_carry(nw, nd)
    if scale is not None:
        carry["log_adj"].fill_(float(np.log(np.float32(scale))))
    model = Model(wrap_log_prob_fn(lp_batch, vectorize=True), nw, nd)
    prog = ChunkProgram([move], model, seed, coords, lp, (carry,))
    prog.load(coords, lp, offset, (carry,))
    # The uniforms the program's kernels draw (plain versions here).
    extra, log_u = [], []
    for split in range(ns):
        w = philox.walker_words(ng, split, seed, offset, "cpu")
        u_s = philox.roll_uniforms(seed, split, offset, "cpu")[0]
        extra.append(torch.cat([philox.to_uniform(w[0]), u_s[None]]).numpy())
        log_u.append(torch.log(philox.to_uniform(w[1])).numpy())
    prog.program(prog.ws, 0, 1, tune=False)
    assert int(prog.ws.offset) == offset + 1

    jmove = JStretchMove(randomize_split=False, pair_mode="roll")
    jmodel = JModel(
        compute_log_prob=lambda q: (-0.5 * jnp.sum(q**2, axis=-1), None),
        nwalkers=nw)
    jscale = None if scale is None else jnp.exp(
        jnp.float32(np.log(np.float32(scale))))
    jstate, jacc, _ = jmove._propose_blocked(
        jax.random.split(jax.random.key(0), ns), jnp.asarray(np.stack(log_u)),
        jnp.asarray(np.stack(extra)),
        JState(jnp.asarray(coords.numpy()), jnp.asarray(lp.numpy())),
        jmodel, (), ng, jscale)
    np.testing.assert_array_equal(prog.ws.accepted.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(prog.ws.coords.numpy(),
                               np.asarray(jstate.coords), RTOL, ATOL)
    np.testing.assert_allclose(prog.ws.log_prob.numpy(),
                               np.asarray(jstate.log_prob), RTOL, ATOL)
    assert 0 < int(jacc.sum()) < nw
