"""The port's DE move (K5a) against the JAX package.

Exact parity under injected randomness: ``DEMove.get_proposal`` in the
JAX package draws its own normals (and, in random mode, its own pairs)
from the key it is given and takes no ``extra=``, so each test
reproduces those draws from the same key and injects them into the
port.  The arithmetic is the same float32 expression on both sides
(XLA may contract ``s + gamma * diff`` into an FMA where eager PyTorch
rounds twice), so ``q`` agrees to rtol = atol = 1e-6 and the acceptance
of a whole proposal is identical.  Then the statistical oracle of
``tests/integration/test_de.py`` for the blocked roll configuration (the
rest is in ``test_torch_de_oracle*.py``, files of their own so that the
slow runs spread over test workers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu.model import Model as JModel
from emcee_tpu.moves import DEMove as JDEMove
from emcee_tpu.state import State as JState

from emcee_tpu_torch import convert, moves
from emcee_tpu_torch.model import Model, wrap_log_prob_fn
from emcee_tpu_torch.ops import de_kernel
from emcee_tpu_torch.ops.de_kernel import (
    de_gamma0, de_propose, de_propose_plain, de_roll_shifts)
from emcee_tpu_torch.state import State
from tests.test_torch_sampler import _test_normal

RTOL, ATOL = 1e-6, 1e-6


def blocks(coords, ns):
    ng = coords.shape[0] // ns
    return [coords[j * ng:(j + 1) * ng] for j in range(ns)]


def jax_de_draws(key, pair_mode, ng, nc):
    """The draws ``DEMove.get_proposal`` makes from ``key``
    (``emcee_tpu/moves/de.py:62-64,73-83``), as port injection keywords."""
    if pair_mode == "roll":
        z = jax.random.normal(key, (ng + 2,), dtype=jnp.float32)
        u = jax.scipy.stats.norm.cdf(z[ng:])
        return dict(z=torch.from_numpy(np.asarray(z[:ng])),
                    u_shift=torch.from_numpy(np.asarray(u)))
    key_i, key_j, key_g = jax.random.split(key, 3)
    i = jax.random.randint(key_i, (ng,), 0, nc)
    j = jax.random.randint(key_j, (ng,), 0, nc - 1)
    z = jax.random.normal(key_g, (ng, 1), dtype=jnp.float32)
    return dict(z=torch.from_numpy(np.asarray(z[:, 0])),
                idx_a=torch.from_numpy(np.asarray(i, dtype=np.int32)),
                idx_b=torch.from_numpy(np.asarray(j, dtype=np.int32)))


@pytest.mark.parametrize("pair_mode", ["roll", "random"])
@pytest.mark.parametrize("nsplits", [2, 4])
@pytest.mark.parametrize("sigma,gamma0,scale", [
    (1e-5, None, None), (0.5, None, 0.7), (0.3, 1.0, None)])
def test_k5a_matches_jax_get_proposal(pair_mode, nsplits, sigma, gamma0,
                                      scale):
    rng = np.random.default_rng(30 + nsplits)
    nw, nd = 48, 5
    ng = nw // nsplits
    coords = rng.normal(size=(nw, nd)).astype(np.float32)
    jmove = JDEMove(sigma=sigma, gamma0=gamma0, pair_mode=pair_mode,
                    nsplits=nsplits)
    jmodel = JModel(compute_log_prob=None, nwalkers=nw)
    for split in range(nsplits):
        key = jax.random.key(100 + split)
        bl = blocks(coords, nsplits)
        c_parts = tuple(jnp.asarray(b) for j, b in enumerate(bl)
                        if j != split)
        kw = {} if scale is None else dict(scale=jnp.float32(scale))
        jq, jf = jmove.get_proposal(key, jnp.asarray(bl[split]), c_parts,
                                    jmodel, **kw)
        q, f = de_propose_plain(
            torch.from_numpy(coords), split, nsplits,
            gamma0=de_gamma0(gamma0, nd), sigma=sigma,
            scale=None if scale is None else torch.tensor(scale),
            pair_mode=pair_mode, **jax_de_draws(key, pair_mode, ng, nw - ng),
        )
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), RTOL, ATOL)
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))


def test_roll_shifts_are_distinct_and_cover_the_complement():
    nc = 37
    rng = np.random.default_rng(2)
    seen = set()
    for u1, u2 in rng.uniform(size=(400, 2)).astype(np.float32):
        s1, s2 = (int(s) for s in de_roll_shifts(u1, u2, nc))
        assert 0 <= s1 < nc and 0 <= s2 < nc and s1 != s2
        seen.add((s1, s2))
    assert de_roll_shifts(np.float32(1 - 2**-24), 0.0, nc)[0] < nc
    assert len({s for s, _ in seen}) > nc // 2


@pytest.mark.parametrize("pair_mode", ["roll", "random"])
def test_pairs_are_distinct_and_in_the_complement(pair_mode):
    """One-hot rows reveal each walker's pair: with sigma = 0 and
    gamma0 = 1, q - s = e_b - e_a exactly."""
    nw, ns = 40, 4
    ng = nw // ns
    coords = torch.eye(nw)
    seen = set()
    for split in range(ns):
        for offset in range(5):
            q, _ = de_propose_plain(coords, split, ns, gamma0=1.0, sigma=0.0,
                                    pair_mode=pair_mode, seed=3,
                                    offset=offset)
            d = q - coords[split * ng:(split + 1) * ng]
            a, b = d.argmin(1), d.argmax(1)
            assert torch.equal(d.min(1).values, -torch.ones(ng))
            assert torch.equal(d.max(1).values, torch.ones(ng))
            for r in (a, b):
                assert bool(((r < split * ng) | (r >= (split + 1) * ng)).all())
            seen.update(zip(a.tolist(), b.tolist()))
    assert len(seen) > nw


def test_philox_normals_are_standard():
    """The Box-Muller normals of the stream (words 0 and 2)."""
    from scipy import stats

    from emcee_tpu_torch.ops.philox import box_muller, walker_words

    w0, _, w2, _ = walker_words(20000, 0, 11, 5, "cpu")
    z = box_muller(w0, w2).numpy()
    assert np.isfinite(z).all()
    assert abs(z.mean()) < 0.03 and abs(z.std() - 1) < 0.03
    assert stats.kstest(z, "norm").statistic < 0.02


@pytest.mark.parametrize("pair_mode", ["roll", "random"])
@pytest.mark.parametrize("scale", [None, 1.3])
def test_blocked_proposal_matches_jax(pair_mode, scale):
    """One whole blocked DE proposal (both splits, K5a then K2) against
    the JAX ``_propose_blocked``, with the JAX draws of each split key
    injected; 24 walkers x 6-D."""
    rng = np.random.default_rng(40)
    nw, nd, ns = 24, 6, 2
    ng = nw // ns
    sigma = 0.2
    coords = rng.normal(size=(nw, nd)).astype(np.float32)
    lp = (-0.5 * (coords**2).sum(-1)).astype(np.float32)
    jmove = JDEMove(sigma=sigma, pair_mode=pair_mode, randomize_split=False)
    jmodel = JModel(
        compute_log_prob=lambda q: (-0.5 * jnp.sum(q**2, axis=-1), None),
        nwalkers=nw,
    )
    jscale = None if scale is None else jnp.float32(scale)
    move = moves.DEMove(sigma=sigma, pair_mode=pair_mode,
                        randomize_split=False)
    model = Model(
        compute_log_prob=wrap_log_prob_fn(lambda x: -0.5 * (x**2).sum(-1),
                                          vectorize=True),
        nwalkers=nw, ndim=nd,
    )
    tscale = None if scale is None else torch.tensor(scale)
    n_acc = 0
    for step in range(4):
        split_keys = jax.random.split(jax.random.key(step), ns)
        log_acc_u = np.log(rng.uniform(size=(ns, ng)).astype(np.float32))
        jstate = JState(jnp.asarray(coords), jnp.asarray(lp))
        jstate, jacc, _ = jmove._propose_blocked(
            split_keys, jnp.asarray(log_acc_u), None, jstate, jmodel, (), ng,
            jscale)
        state = State(torch.from_numpy(coords.copy()),
                      torch.from_numpy(lp.copy()), None, (0, step))
        extra = [jax_de_draws(split_keys[j], pair_mode, ng, nw - ng)
                 for j in range(ns)]
        state, acc, _ = move._propose_blocked(
            (0, step), state, model, (), ng, tscale,
            log_acc_u=torch.from_numpy(log_acc_u), extra_u=extra,
        )
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
        np.testing.assert_allclose(state.coords.numpy(),
                                   np.asarray(jstate.coords), RTOL, ATOL)
        np.testing.assert_allclose(state.log_prob.numpy(),
                                   np.asarray(jstate.log_prob), 1e-5, 1e-5)
        n_acc += int(acc.sum())
        coords = np.asarray(jstate.coords).copy()
        lp = np.asarray(jstate.log_prob).copy()
    assert 0 < n_acc < 4 * nw


def test_tuned_carry_resumes_at_the_same_scale():
    """A JAX DE run tuned toward an acceptance target; its carry, through
    numpy and ``convert.carry_from_numpy``, gives the port the same scale
    and the same next Robbins-Monro step."""
    from emcee_tpu import EnsembleSampler as JSampler

    nw, nd = 16, 2
    p0 = np.random.default_rng(0).normal(size=(nw, nd))
    js = JSampler(nw, nd, lambda x: -0.5 * jnp.sum(x**2, axis=-1),
                  vectorize=True, seed=0,
                  moves=JDEMove(tune_target=0.2, randomize_split=False))
    js.run_mcmc(p0, 30, tune=True)
    jcarry = js._move_carries[0]
    np_carry = {k: np.asarray(v) for k, v in jcarry.items()}
    assert float(np_carry["log_adj"]) != 0.0 and int(np_carry["t"]) == 30
    carry = convert.carry_from_numpy(np_carry, device="cpu")
    assert carry["log_adj"].dtype == torch.float32
    assert carry["t"].dtype == torch.int32
    move = moves.DEMove(tune_target=0.2, randomize_split=False)
    jmove = js._moves[0]
    np.testing.assert_array_equal(
        move._tuned_scale(carry, torch.float32).numpy(),
        np.asarray(jmove._tuned_scale(jcarry, jnp.float32)))
    acc = np.random.default_rng(1).uniform(size=nw) < 0.4
    nxt = move.tune(carry, None, torch.from_numpy(acc))
    jnxt = jmove.tune(jcarry, None, jnp.asarray(acc))
    np.testing.assert_allclose(nxt["log_adj"].numpy(),
                               np.asarray(jnxt["log_adj"]), 1e-6, 1e-7)
    assert int(nxt["t"]) == int(jnxt["t"])
    assert convert.carry_from_numpy((), device="cpu") == ()
    with pytest.raises(ValueError):
        convert.carry_from_numpy({"scale": 1.0}, device="cpu")


def test_wrapper_uses_the_plain_version_only_on_cpu():
    coords = torch.randn(16, 3)
    before = de_propose.launches
    kw = dict(gamma0=0.5, sigma=0.1, pair_mode="roll", seed=3, offset=4)
    q, f = de_kernel.de_propose(coords, 1, 2, **kw)
    qp, fp = de_propose_plain(coords, 1, 2, **kw)
    assert torch.equal(q, qp) and torch.equal(f, fp)
    assert de_propose.launches == before
    with pytest.raises(ValueError, match="no K5a kernel"):
        de_kernel.de_propose(torch.empty(16, 3, device="meta"), 1, 2, **kw)


def test_de_move_arguments():
    with pytest.raises(ValueError, match="pair_mode"):
        moves.DEMove(pair_mode="ring")
    mv = moves.DEMove()
    assert (mv.sigma, mv.gamma0, mv.pair_mode, mv.nsplits,
            mv.randomize_split, mv.tunable) == (1e-5, None, "random", 2,
                                                True, True)
    assert de_gamma0(None, 100) == float(
        np.float32(2.38) / np.sqrt(np.float32(200.0)))


def test_normal_de_roll_blocked():
    _test_normal(moves.DEMove(randomize_split=False, pair_mode="roll"))
