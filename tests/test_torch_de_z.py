"""The port's DE-Z move against the JAX package.

``update_carry`` (the archive ring) is integer indexing and copies, so it
equals JAX's ``DEZMove.update_carry`` bit for bit over enough calls to
wrap the ring.  The proposal is held to JAX's ``get_proposal`` under
JAX's own draws, reproduced from the same key and injected into the
port: q and the factors to rtol = atol = 1e-5 (the complement's spread
sums in K10a's order, ``emcee_tpu_torch/ops/dez_kernel.py``: runs of rows,
each shifted by its first row, merged by a pairwise tree of Chan's
combine; the snooker norms sum in column order).  Then the carry through
``convert``, the archive through the sampler, and the statistical
oracles of ``tests/integration/test_de_z.py`` (one in the fast tier).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu import moves as jmoves
from emcee_tpu.model import Model as JModel
from emcee_tpu.state import State as JState

import emcee_tpu_torch
from emcee_tpu_torch import convert, moves
from emcee_tpu_torch.model import Model, wrap_log_prob_fn
from emcee_tpu_torch.state import State
from tests.test_torch_sampler import _test_normal, _test_uniform

NW, ND = 40, 3


def lp_batch(x):
    return -0.5 * (x**2).sum(-1)


def model(nw=NW, nd=ND):
    return Model(wrap_log_prob_fn(lp_batch, vectorize=True), nw, nd)


def jmodel(nw=NW, nd=ND):
    return JModel(lambda x: (-0.5 * jnp.sum(x**2, axis=-1), None),
                  nwalkers=nw, ndim=nd)


def np_carry(carry):
    return {k: np.array(v) for k, v in carry.items()}


@pytest.mark.parametrize("archive_size,update_rows", [
    (100, 24), (32, 8), (None, 64), (45, 7)])
def test_update_carry_matches_jax_bit_for_bit(archive_size, update_rows):
    kw = dict(archive_size=archive_size, update_rows=update_rows)
    jmove, move = jmoves.DEZMove(**kw), moves.DEZMove(**kw)
    jcarry = jmove.init_carry(NW, ND)
    carry = move.init_carry(NW, ND, device="cpu")
    k = carry["z"].shape[0]
    assert jcarry["z"].shape[0] == k
    rows = min(update_rows, NW)
    ncalls = 2 * k // rows + 3  # the ring wraps at least twice
    rng = np.random.default_rng(archive_size or 0)
    for _ in range(ncalls):
        x = rng.normal(size=(NW, ND)).astype(np.float32)
        jcarry = jmove.update_carry(jcarry, JState(jnp.asarray(x)),
                                    jmodel())
        out = move.update_carry(carry, State(torch.from_numpy(x)), model())
        assert out is carry  # in place
        for key, v in np_carry(jcarry).items():
            got = carry[key].numpy()
            assert got.dtype == v.dtype and np.array_equal(got, v), key
    assert int(carry["filled"]) == k


def test_init_carry_matches_jax():
    seed = np.random.default_rng(1).normal(size=(30, ND))
    for kw in ({}, {"archive_init": seed, "archive_size": 50,
                    "update_rows": 16},
               {"archive_init": seed, "archive_size": 20,
                "update_rows": 10}):
        jc = np_carry(jmoves.DEZMove(**kw).init_carry(NW, ND))
        c = moves.DEZMove(**kw).init_carry(NW, ND, device="cpu")
        for key, v in jc.items():
            assert c[key].numpy().dtype == v.dtype
            assert np.array_equal(c[key].numpy(), v), key


def test_constructor_errors_match_jax():
    for kw, match in (({"g1_prob": 1.5}, "g1_prob"),
                      ({"snooker_prob": -0.1}, "snooker_prob"),
                      ({"de_noise": -1.0}, "de_noise"),
                      ({"update_rows": 0}, "update_rows"),
                      ({"archive_init": np.zeros(5)}, "archive_init")):
        for mod in (moves, jmoves):
            with pytest.raises(ValueError, match=match):
                mod.DEZMove(**kw)
    move = moves.DEZMove(archive_init=np.zeros((4, 3)))
    with pytest.raises(ValueError, match="ndim"):
        move.init_carry(8, 2, device="cpu")
    # One update's rows against the ring: refused when the carry is
    # made, on the host (the JAX package refuses it in update_carry, at
    # trace time, where only walker sharding reaches it).
    with pytest.raises(ValueError, match="archive_size"):
        moves.DEZMove(archive_size=0).init_carry(8, 2, device="cpu")
    mv = moves.DEZMove()
    assert (mv.wants_carry, mv.blendable, mv._param_shard_ok) == (
        True, False, False)


def jax_dez_draws(key, ng, nd, n_avail, g1_prob, snooker_prob):
    """The draws of ``emcee_tpu/moves/de_z.py:157-213`` from ``key``, as
    port injection keywords."""
    (key_i, key_j, key_g, key_1, key_e, key_s, key_a, key_b,
     key_c) = jax.random.split(key, 9)

    def ints(k, hi):
        return torch.from_numpy(np.array(jax.random.randint(k, (ng,), 0,
                                                            hi)))

    gamma = jax.random.normal(key_g, (ng, 1), dtype=jnp.float32)
    noise = jax.random.normal(key_e, (ng, nd), dtype=jnp.float32)
    return dict(
        i=ints(key_i, n_avail), j=ints(key_j, n_avail - 1),
        a=ints(key_a, n_avail), b=ints(key_b, n_avail),
        e=ints(key_c, n_avail),
        jump=torch.from_numpy(np.array(
            jax.random.uniform(key_1, (ng, 1)) < g1_prob))[:, 0],
        snooker=torch.from_numpy(np.array(
            jax.random.uniform(key_s, (ng,)) < snooker_prob)),
        z=torch.from_numpy(np.concatenate(
            [np.array(gamma), np.array(noise)], axis=1)))


@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("kw", [
    {}, {"snooker_prob": 1.0}, {"g1_prob": 0.5, "de_noise": 0.3},
    {"g1_prob": 0.0, "snooker_prob": 0.0, "de_noise": 0.0}])
@pytest.mark.parametrize("filled", [0, 17])
def test_proposal_matches_jax_under_its_draws(split, kw, filled):
    rng = np.random.default_rng(split + filled)
    x = rng.normal(size=(NW, ND)).astype(np.float32)
    jmove, move = jmoves.DEZMove(archive_size=64, **kw), moves.DEZMove(
        archive_size=64, **kw)
    carry = move.init_carry(NW, ND, device="cpu")
    carry["z"][:filled] = torch.from_numpy(
        rng.normal(size=(filled, ND)).astype(np.float32))
    carry["filled"].fill_(filled)
    jcarry = {k: jnp.asarray(v.numpy()) for k, v in carry.items()}
    ng = NW // 2
    key = jax.random.key(5 + split)
    s = x[split * ng:(split + 1) * ng]
    c_parts = (x[(1 - split) * ng:(2 - split) * ng],)
    jq, jf = jmove.get_proposal(key, jnp.asarray(s), c_parts, jmodel(),
                                carry=jcarry)
    draws = jax_dez_draws(key, ng, ND, NW - ng + filled, jmove.g1_prob,
                          jmove.snooker_prob)
    q, f = move.get_proposal((1, 2), torch.from_numpy(x), split, model(),
                             extra=draws, carry=carry)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), 1e-5, 1e-5)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), 1e-5, 1e-5)


def test_pool_reads_the_archive_without_a_copy():
    """A pick past the complement reads the archive's row: with every
    pick forced to one archive row the DE difference is zero and the
    snooker anchor is that row."""
    move = moves.DEZMove(g1_prob=0.0, de_noise=0.0, snooker_prob=1.0,
                         archive_size=64)
    carry = move.init_carry(NW, ND, device="cpu")
    carry["z"][:5] = torch.arange(15.0).view(5, 3)
    carry["filled"].fill_(5)
    ng = NW // 2
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(NW, ND)).astype(np.float32))
    r = torch.full((ng,), NW - ng + 3)
    draws = dict(i=r, j=r - 1, a=r, b=r, e=r, jump=torch.zeros(ng, dtype=bool),
                 snooker=torch.ones(ng, dtype=bool), z=torch.zeros(ng, 4))
    q, f = move.get_proposal((1, 2), x, 0, model(), extra=draws,
                             carry=carry)
    # b == e: no step along the anchor direction; factor log(1) = 0.
    assert torch.equal(q, x[:ng]) and torch.allclose(f, torch.zeros(ng))
    # DE from archive rows 3 and 4 (j = i is moved past i): the step is
    # gamma0 (row 4 - row 3) = gamma0 (3, 3, 3).
    move.snooker_prob = 0.0
    draws["j"] = r
    q, _ = move.get_proposal((1, 2), x, 0, model(), extra=draws,
                             carry=carry)
    g0 = np.float32(2.38) / np.sqrt(np.float32(2.0 * ND))
    assert torch.equal(q, x[:ng] + float(g0) * torch.full((ND,), 3.0))


def test_archive_fills_and_wraps_through_the_sampler():
    """``tests/integration/test_de_z.py:25-40`` on the port."""
    nwalkers, ndim = 32, 2
    mv = moves.DEZMove(archive_size=128, update_rows=64)
    s = emcee_tpu_torch.EnsembleSampler(nwalkers, ndim, lp_batch,
                                        vectorize=True, moves=mv, seed=0,
                                        device="cpu")
    coords = np.random.default_rng(0).normal(size=(nwalkers, ndim))
    s.run_mcmc(coords, 10)
    carry = {k: v.numpy() for k, v in s._move_carries[0].items()}
    assert carry["z"].shape == (128, ndim)
    assert carry["filled"] == 128 and carry["ptr"] == (10 * 32) % 128
    assert carry["t"] == 10
    last = carry["z"][32:64]
    assert len(np.unique(last, axis=0)) == 32


@pytest.mark.parametrize("move", [
    lambda: moves.DEZMove(archive_size=96, update_rows=16),
    lambda: moves.DIMEMove(n_components=2, aimh_prob=0.5)])
def test_carry_resumes_across_runs(move):
    """The chunk program copies a carry of any shape into its workspace
    and hands it back after each chunk (``clone_carry``, ``load``): two
    runs of 6 and 5 kept steps, the second resumed, equal one run of 11,
    archive and moments included."""
    p0 = np.random.default_rng(4).normal(size=(32, 2))
    ends = []
    for parts in ((11,), (6, 5)):
        s = emcee_tpu_torch.EnsembleSampler(32, 2, lp_batch, vectorize=True,
                                            moves=move(), seed=3,
                                            device="cpu", max_chunk_steps=4)
        s.run_mcmc(p0, parts[0])
        for n in parts[1:]:
            s.run_mcmc(None, n)
        ends.append((s.get_chain(), s._move_carries[0]))
    assert np.array_equal(ends[0][0], ends[1][0])
    for k, v in ends[0][1].items():
        assert torch.equal(v, ends[1][1][k]), k


def test_carry_converts_from_jax():
    """A JAX run's archive carry (the JAX move's own updates) continues in
    the port: through numpy and ``convert.carry_from_numpy`` every leaf
    keeps its dtype and value, and the port's next update equals JAX's."""
    nw, nd = 16, 2
    jmove = jmoves.DEZMove(archive_size=48, update_rows=16)
    jcarry = jmove.init_carry(nw, nd)
    rng = np.random.default_rng(0)
    for _ in range(7):
        jcarry = jmove.update_carry(jcarry, JState(jnp.asarray(
            rng.normal(size=(nw, nd)).astype(np.float32))), jmodel(nw, nd))
    carry = convert.carry_from_numpy(np_carry(jcarry), device="cpu")
    for k, v in np_carry(jcarry).items():
        assert carry[k].numpy().dtype == v.dtype
        assert np.array_equal(carry[k].numpy(), v)
    x = rng.normal(size=(nw, nd)).astype(np.float32)
    jnext = jmove.update_carry(jcarry, JState(jnp.asarray(x)),
                               jmodel(nw, nd))
    moves.DEZMove(archive_size=48, update_rows=16).update_carry(
        carry, State(torch.from_numpy(x)), model(nw, nd))
    for k, v in np_carry(jnext).items():
        assert np.array_equal(carry[k].numpy(), v), k
    with pytest.raises(ValueError, match="not a move carry"):
        convert.carry_from_numpy({"z": 0, "filled": 0}, device="cpu")


def test_normal_de_z():
    """The fast oracle of ``test_de_z.py``."""
    _test_normal(moves.DEZMove())


@pytest.mark.slow
def test_normal_de_z_3d():
    _test_normal(moves.DEZMove(), ndim=3)


@pytest.mark.slow
def test_uniform_de_z():
    _test_uniform(moves.DEZMove())


@pytest.mark.slow
def test_de_z_pure_snooker():
    _test_normal(moves.DEZMove(snooker_prob=1.0), ndim=3, nsteps=3000)


@pytest.mark.slow
def test_de_z_components_off():
    _test_normal(moves.DEZMove(snooker_prob=0.0, g1_prob=0.0, de_noise=0.0))


@pytest.mark.slow
def test_de_z_fewer_walkers_than_2ndim():
    """``test_de_z.py:43-83``: 8 walkers in 10-D, full-rank variance
    along the directions orthogonal to the start's affine hull."""
    nwalkers, ndim, nsteps = 8, 10, 12000
    s = emcee_tpu_torch.EnsembleSampler(
        nwalkers, ndim, lp_batch, vectorize=True, seed=1, device="cpu",
        moves=moves.DEZMove(update_rows=8, de_noise=0.1,
                            live_dangerously=True))
    coords = np.random.default_rng(2).normal(size=(nwalkers, ndim))
    s.run_mcmc(coords, nsteps, skip_initial_state_check=True)
    flat = s.get_chain(discard=nsteps // 2, flat=True)
    assert np.all(np.abs(flat.mean(axis=0)) < 0.2), flat.mean(axis=0)
    assert np.all(np.abs(flat.std(axis=0) - 1.0) < 0.15), flat.std(axis=0)
    centered = coords - coords.mean(axis=0)
    _, sv, vt = np.linalg.svd(centered, full_matrices=True)
    ortho = vt[np.sum(sv > 1e-8):]
    assert np.all((flat @ ortho.T).std(axis=0) > 0.7)
