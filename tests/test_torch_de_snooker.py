"""The port's DE-snooker move (K5b) against the JAX package.

Exact parity under injected randomness: the roll mode takes its four
uniforms as ``extra=`` in both packages; the random mode draws its picks
and role permutations from the key it is given, so the test reproduces
those draws (``split(key, 4)``, three ``randint`` and the permutation
``randint``) and injects them into the port.  The two row sums run in
another order in XLA and in eager PyTorch, so ``q`` agrees to
rtol = atol = 1e-5 and the factor, which is (ndim - 1) times a
difference of logs, to atol = 1e-4; the acceptance of a whole proposal
is identical.  Then the oracle of ``tests/integration/test_de_snooker.py``
for the roll configurations (the rest is in
``test_torch_de_snooker_oracle*.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu.model import Model as JModel
from emcee_tpu.moves import DESnookerMove as JSnookerMove
from emcee_tpu.state import State as JState

from emcee_tpu_torch import moves
from emcee_tpu_torch.model import Model, wrap_log_prob_fn
from emcee_tpu_torch.ops import snooker_kernel
from emcee_tpu_torch.ops.snooker_kernel import (
    PERMS3, role_rows, roll_picks, snooker_propose, snooker_propose_plain)
from emcee_tpu_torch.state import State
from tests.test_torch_sampler import _test_normal

RTOL = ATOL = 1e-5
F_ATOL = 1e-4


def blocks(coords, ns):
    ng = coords.shape[0] // ns
    return [coords[j * ng:(j + 1) * ng] for j in range(ns)]


def jax_random_draws(key, ng):
    """The draws ``DESnookerMove._draw_random`` makes from ``key``
    (``emcee_tpu/moves/de_snooker.py:102-113``), as port keywords."""
    keys = jax.random.split(key, 4)
    idx = np.stack([np.asarray(jax.random.randint(k, (ng,), 0, ng))
                    for k in keys[:3]]).astype(np.int32)
    perm = np.asarray(jax.random.randint(keys[3], (ng,), 0, 6), np.int32)
    return dict(idx=torch.from_numpy(idx), perm=torch.from_numpy(perm))


CASES = [("roll", 2), ("roll", 4), ("random", 4)]


@pytest.mark.parametrize("pair_mode,nsplits", CASES)
@pytest.mark.parametrize("gammas,scale", [(1.7, None), (1.3, 0.6)])
def test_k5b_matches_jax_get_proposal(pair_mode, nsplits, gammas, scale):
    rng = np.random.default_rng(50 + nsplits)
    nw, nd = 48, 5
    ng = nw // nsplits
    coords = rng.normal(size=(nw, nd)).astype(np.float32)
    jmove = JSnookerMove(gammas=gammas, pair_mode=pair_mode,
                         nsplits=nsplits)
    jmodel = JModel(compute_log_prob=None, nwalkers=nw)
    for split in range(nsplits):
        key = jax.random.key(200 + split)
        u4 = rng.uniform(size=4).astype(np.float32)
        if split == 1:
            u4[1:] = 1.0 - 2.0**-24  # shifts at the top of their range
        bl = blocks(coords, nsplits)
        c_parts = tuple(jnp.asarray(b) for j, b in enumerate(bl)
                        if j != split)
        kw = {} if scale is None else dict(scale=jnp.float32(scale))
        if pair_mode == "roll":
            kw["extra"] = jnp.asarray(u4)
            inject = dict(u4=torch.from_numpy(u4))
        else:
            inject = jax_random_draws(key, ng)
        jq, jf = jmove.get_proposal(key, jnp.asarray(bl[split]), c_parts,
                                    jmodel, **kw)
        q, f = snooker_propose_plain(
            torch.from_numpy(coords), split, nsplits, gammas=gammas,
            scale=None if scale is None else torch.tensor(scale),
            ndim_global=nd, pair_mode=pair_mode, **inject,
        )
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), RTOL, ATOL)
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), 0, F_ATOL)


def test_roll_picks():
    """Role groups and shifts: nsplits=2 keeps the pick order in the one
    other group; nsplits=4 permutes one pick from each other group."""
    def pairs(*args):
        groups, shifts = roll_picks(*args)
        return list(zip(groups.tolist(), shifts.tolist()))

    u4 = [0.99, 0.0, 0.5, 0.75]
    assert pairs(u4, 0, 2, 8) == [(1, 0), (1, 4), (1, 6)]
    assert pairs(u4, 1, 2, 8) == [(0, 0), (0, 4), (0, 6)]
    picks = [(0, 0), (2, 4), (3, 6)]  # split 1 of 4
    assert pairs(u4, 1, 4, 8) == [picks[k] for k in PERMS3[5]]
    assert pairs([0.0] + u4[1:], 1, 4, 8) == picks
    assert len(PERMS3) == 6 and len(set(PERMS3)) == 6


@pytest.mark.parametrize("pair_mode,nsplits", CASES)
def test_picks_come_from_the_other_groups(pair_mode, nsplits):
    """The role rows drawn from the stream lie outside the split's block:
    with nsplits=4 the three roles take one row of each other group."""
    ng = 12
    seen = set()
    for split in range(nsplits):
        others = {g for g in range(nsplits) if g != split}
        for offset in range(6):
            rows = role_rows(ng, split, nsplits, pair_mode, "cpu", seed=5,
                             offset=offset)
            groups = torch.stack(rows, 1) // ng
            for g in groups.tolist():
                if nsplits == 4:
                    assert set(g) == others
                else:
                    assert set(g) <= others
            seen.update(torch.cat(rows).tolist())
    assert len(seen) > nsplits * ng // 2
    # gammas = 0 proposes s itself with a zero factor.
    coords = torch.randn(nsplits * ng, 3)
    q, f = snooker_propose_plain(coords, 1, nsplits, gammas=0.0,
                                 ndim_global=3, pair_mode=pair_mode, seed=1)
    assert torch.equal(q, coords[ng:2 * ng])
    assert torch.equal(f, torch.zeros(ng))


@pytest.mark.parametrize("pair_mode,nsplits", CASES)
@pytest.mark.parametrize("scale", [None, 1.2])
def test_blocked_proposal_matches_jax(pair_mode, nsplits, scale):
    """One whole blocked snooker proposal (every split, K5b then K2)
    against the JAX ``_propose_blocked``; 24 walkers x 6-D."""
    rng = np.random.default_rng(60 + nsplits)
    nw, nd = 24, 6
    ng = nw // nsplits
    coords = rng.normal(size=(nw, nd)).astype(np.float32)
    lp = (-0.5 * (coords**2).sum(-1)).astype(np.float32)
    jmove = JSnookerMove(pair_mode=pair_mode, nsplits=nsplits,
                         randomize_split=False)
    jmodel = JModel(
        compute_log_prob=lambda q: (-0.5 * jnp.sum(q**2, axis=-1), None),
        nwalkers=nw,
    )
    jscale = None if scale is None else jnp.float32(scale)
    move = moves.DESnookerMove(pair_mode=pair_mode, nsplits=nsplits,
                               randomize_split=False)
    model = Model(
        compute_log_prob=wrap_log_prob_fn(lambda x: -0.5 * (x**2).sum(-1),
                                          vectorize=True),
        nwalkers=nw, ndim=nd,
    )
    tscale = None if scale is None else torch.tensor(scale)
    n_acc = 0
    for step in range(4):
        split_keys = jax.random.split(jax.random.key(step), nsplits)
        log_acc_u = np.log(rng.uniform(size=(nsplits, ng)).astype(np.float32))
        if pair_mode == "roll":
            u4 = rng.uniform(size=(nsplits, 4)).astype(np.float32)
            jextra, extra = jnp.asarray(u4), torch.from_numpy(u4)
        else:
            jextra = None
            extra = [jax_random_draws(k, ng) for k in split_keys]
        jstate, jacc, _ = jmove._propose_blocked(
            split_keys, jnp.asarray(log_acc_u), jextra,
            JState(jnp.asarray(coords), jnp.asarray(lp)), jmodel, (), ng,
            jscale)
        state = State(torch.from_numpy(coords.copy()),
                      torch.from_numpy(lp.copy()), None, (0, step))
        state, acc, _ = move._propose_blocked(
            (0, step), state, model, (), ng, tscale,
            log_acc_u=torch.from_numpy(log_acc_u), extra_u=extra,
        )
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
        np.testing.assert_allclose(state.coords.numpy(),
                                   np.asarray(jstate.coords), RTOL, ATOL)
        np.testing.assert_allclose(state.log_prob.numpy(),
                                   np.asarray(jstate.log_prob), RTOL, ATOL)
        n_acc += int(acc.sum())
        coords = np.asarray(jstate.coords).copy()
        lp = np.asarray(jstate.log_prob).copy()
    assert 0 < n_acc < 4 * nw


def test_wrapper_uses_the_plain_version_only_on_cpu():
    coords = torch.randn(16, 3)
    before = snooker_propose.launches
    kw = dict(gammas=1.7, ndim_global=3, pair_mode="roll", seed=3, offset=4)
    q, f = snooker_kernel.snooker_propose(coords, 1, 2, **kw)
    qp, fp = snooker_propose_plain(coords, 1, 2, **kw)
    assert torch.equal(q, qp) and torch.equal(f, fp)
    assert snooker_propose.launches == before
    with pytest.raises(ValueError, match="no K5b kernel"):
        snooker_kernel.snooker_propose(torch.empty(16, 3, device="meta"), 1,
                                       2, **kw)


def test_snooker_move_arguments():
    with pytest.raises(ValueError, match="pair_mode"):
        moves.DESnookerMove(pair_mode="ring")
    with pytest.raises(ValueError, match="nsplits"):
        moves.DESnookerMove(nsplits=2)
    with pytest.raises(ValueError, match="nsplits"):
        moves.DESnookerMove(pair_mode="roll", nsplits=3)
    mv = moves.DESnookerMove()
    assert (mv.gammas, mv.pair_mode, mv.nsplits, mv.randomize_split,
            mv.tunable) == (1.7, "random", 4, True, True)
    assert moves.DESnookerMove(pair_mode="roll", nsplits=2).nsplits == 2


def test_normal_de_snooker_roll_blocked():
    _test_normal(
        moves.DESnookerMove(pair_mode="roll", randomize_split=False),
        nsteps=4000,
    )


def test_normal_de_snooker_roll_2split():
    _test_normal(
        moves.DESnookerMove(pair_mode="roll", nsplits=2,
                            randomize_split=False),
        nsteps=4000,
    )
