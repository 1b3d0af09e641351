"""The port's side and blended moves against the JAX package, and the
extension moves' Philox counter blocks.

Side: exact parity under injected draws: ``SideMove.get_proposal`` in the
JAX package draws its own normals and pairs from the key it is given, so
each test reproduces those draws from the same key and injects them into
the port; both compute the same float32 expression (XLA may contract it
into an FMA), hence rtol = atol = 1e-6.

Blended: under an injected choice the port's proposal equals the chosen
sub-move's proposal on its own stream bit for bit, and the choices'
frequencies match the weights.  Then the fast statistical oracles of
``tests/integration/test_side.py`` and ``test_mixture.py`` (the rest
``slow``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu import moves as jmoves
from emcee_tpu.model import Model as JModel

from emcee_tpu_torch import moves
from emcee_tpu_torch.model import Model, wrap_log_prob_fn
from emcee_tpu_torch.ops import philox
from emcee_tpu_torch.ops.de_kernel import walker_normal
from emcee_tpu_torch.ops.philox import (
    BLEND_BLOCK, ROLL_LANE, philox4x32, roll_uniforms, split_key, sub_seed,
    to_uniform, walker_words)
from tests.test_torch_sampler import _test_normal, _test_uniform

NW, ND = 40, 3
RTOL = ATOL = 1e-6


def lp_batch(x):
    return -0.5 * (x**2).sum(-1)


def model():
    return Model(wrap_log_prob_fn(lp_batch, vectorize=True), NW, ND)


def jmodel():
    return JModel(lambda x: (-0.5 * jnp.sum(x**2, axis=-1), None),
                  nwalkers=NW, ndim=ND)


def coords(seed=0):
    return np.random.default_rng(seed).normal(size=(NW, ND)).astype(
        np.float32)


def jax_side_draws(key, pair_mode, ng, nc):
    """The draws of ``emcee_tpu/moves/side.py:62-82`` from ``key``, as
    port injection keywords."""
    if pair_mode == "roll":
        z = jax.random.normal(key, (ng + 2,), dtype=jnp.float32)
        u = jax.scipy.stats.norm.cdf(z[ng:])
        return dict(z=torch.from_numpy(np.array(z[:ng])),
                    u_shift=torch.from_numpy(np.array(u)))
    key_i, key_j, key_z = jax.random.split(key, 3)
    i = jax.random.randint(key_i, (ng,), 0, nc)
    j = jax.random.randint(key_j, (ng,), 0, nc - 1)
    z = jax.random.normal(key_z, (ng, 1), dtype=jnp.float32)
    return dict(z=torch.from_numpy(np.array(z[:, 0])),
                idx_a=torch.from_numpy(np.array(i, dtype=np.int32)),
                idx_b=torch.from_numpy(np.array(j, dtype=np.int32)))


@pytest.mark.parametrize("pair_mode", ["roll", "random"])
@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("scale", [None, 0.7])
def test_side_step_matches_jax_under_its_draws(pair_mode, split, scale):
    x = coords(split + 3)
    ng = NW // 2
    key = jax.random.key(11 + split)
    s = x[split * ng:(split + 1) * ng]
    c_parts = (x[(1 - split) * ng:(2 - split) * ng],)
    jmove = jmoves.SideMove(pair_mode=pair_mode)
    kw = {} if scale is None else {"scale": jnp.float32(scale)}
    jq, jf = jmove.get_proposal(key, jnp.asarray(s), c_parts, jmodel(), **kw)
    q, f = moves.SideMove(pair_mode=pair_mode).get_proposal(
        (1, 2), torch.from_numpy(x), split, model(),
        extra=jax_side_draws(key, pair_mode, ng, NW - ng),
        scale=None if scale is None else torch.tensor(scale))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), RTOL, ATOL)
    assert not f.any() and not np.asarray(jf).any()


@pytest.mark.parametrize("pair_mode", ["roll", "random"])
def test_side_draws_from_its_counters(pair_mode):
    """The amplitude is the walker's Box-Muller normal at ``(walker,
    split)``; the pairs are DE's: the roll words or the PAIR_BLOCK
    picks."""
    x = torch.from_numpy(coords(5))
    ng, split, rng = NW // 2, 1, (6, 7)
    mv = moves.SideMove(pair_mode=pair_mode)
    q, _ = mv.get_proposal(rng, x, split, model())
    extra = {"z": walker_normal(ng, split, *rng, "cpu")}
    if pair_mode == "roll":
        extra["u_shift"] = roll_uniforms(*rng[:1], split, rng[1], "cpu")[:2]
    else:
        w = walker_words(ng, philox.PAIR_BLOCK | split, *rng, "cpu")
        nc = NW - ng
        extra["idx_a"] = torch.clamp((to_uniform(w[0]) * nc).long(),
                                     max=nc - 1)
        extra["idx_b"] = torch.clamp((to_uniform(w[1]) * (nc - 1)).long(),
                                     max=nc - 2)
    q2, _ = mv.get_proposal(rng, x, split, model(), extra=extra)
    assert torch.equal(q, q2)


def test_side_constructor_matches_jax():
    for kw in ({}, {"sigma": 0.4, "pair_mode": "roll", "nsplits": 4}):
        a, b = moves.SideMove(**kw), jmoves.SideMove(**kw)
        assert (a.sigma, a.pair_mode, a.nsplits, a.randomize_split) == (
            b.sigma, b.pair_mode, b.nsplits, b.randomize_split)
        assert a.tunable and a.blendable
    for bad in ("nope", "both"):
        with pytest.raises(ValueError, match="pair_mode"):
            moves.SideMove(pair_mode=bad)


def blended(**kw):
    return moves.BlendedMove(
        [(moves.DEMove(pair_mode="roll"), 0.8),
         (moves.DESnookerMove(pair_mode="roll", nsplits=2), 0.2)],
        randomize_split=False, **kw)


@pytest.mark.parametrize("choice", [0, 1])
@pytest.mark.parametrize("split", [0, 1])
def test_blended_equals_the_chosen_sub_move(choice, split):
    """Under an injected choice, (q, factors) is the chosen sub-move's,
    drawn on its own key (``sub_seed``), bit for bit."""
    x = torch.from_numpy(coords(7))
    bl = blended()
    seed, offset = 21, 5
    q, f = bl.get_proposal((seed, offset), x, split, model(),
                           extra={"choice": choice})
    sub = bl._moves[choice]
    q2, f2 = sub.get_proposal((sub_seed(seed, choice), offset), x, split,
                              model())
    assert torch.equal(q, q2)
    assert torch.equal(f, f2.expand(NW // 2))
    # The engine's per-proposal draw: the choice of every split at once.
    want = bl._split_draws((seed, offset), "cpu")[split]
    got, _ = bl.get_proposal((seed, offset), x, split, model(), extra=want)
    q3, _ = bl.get_proposal((seed, offset), x, split, model(),
                            extra={"choice": int(want)})
    assert torch.equal(got, q3)


def test_blended_choice_frequencies_match_the_weights():
    weights = np.array([0.2, 0.3, 0.5])
    bl = moves.BlendedMove(
        list(zip([moves.DEMove(), moves.SideMove(), moves.StretchMove()],
                 weights)))
    n = 40000
    seed = 3
    offsets = torch.arange(n, dtype=torch.int64)
    lane = torch.full((), ROLL_LANE, dtype=torch.int64)
    for split in (0, 1):
        w0 = philox4x32(lane, BLEND_BLOCK | split, offsets, 0,
                        split_key(seed))[0]
        idx = bl.choice(to_uniform(w0)).numpy()
        freq = np.bincount(idx, minlength=3) / n
        sd = np.sqrt(weights * (1 - weights) / n)
        assert np.all(np.abs(freq - weights) < 5 * sd), freq
    # The engine's draw is that counter's word.
    for off in (0, 9, 2**33 + 1):
        got = bl._split_draws((seed, off), "cpu")
        for split in (0, 1):
            w = philox.philox4x32_scalar(
                (ROLL_LANE, BLEND_BLOCK | split, off & philox.MASK32,
                 off >> 32), split_key(seed))[0]
            u = (w >> 8) * 2.0**-24
            assert int(got[split]) == int(np.searchsorted(
                np.cumsum(weights)[:-1], u, side="right"))


def test_blended_validation_matches_jax():
    bad = [
        ([moves.DEMove()], "at least two"),
        ([moves.DEMove(), moves.GaussianMove(0.5)], "red-blue"),
        ([moves.DEMove(), moves.DESnookerMove()], "nsplits"),
        ([(moves.DEMove(), -1.0), (moves.SideMove(), 2.0)], "weights"),
        ([(moves.DEMove(), 0.0), (moves.SideMove(), 0.0)], "weights"),
        ([moves.EnsembleSliceMove(), moves.StretchMove()],
         "cannot be blended"),
        ([moves.DEZMove(), moves.StretchMove()], "cannot be blended"),
        ([moves.DIMEMove(), moves.StretchMove()], "cannot be blended"),
    ]
    for mvs, match in bad:
        with pytest.raises(ValueError, match=match):
            moves.BlendedMove(mvs)
    with pytest.raises(ValueError, match="mode"):
        moves.BlendedMove([moves.DEMove(), moves.SideMove()], mode="x")
    for cls in (moves.EnsembleSliceMove, moves.DEZMove, moves.DIMEMove):
        assert cls.blendable is False
        assert getattr(jmoves, cls.__name__).blendable is False
    bl = blended(mode="switch")
    assert bl.mode == "switch" and bl.nsplits == 2
    np.testing.assert_allclose(bl._weights, [0.8, 0.2])


def _block_ranges():
    """Every Philox counter block as ``(lanes, first split word, last
    split word)``: ``rows`` for walker or row lanes, or one named lane."""
    n = 1 << 16  # far more splits than any move uses
    k = 1 << 20  # normals and picks per row: ndim up to 2**20
    return {
        "walker": ("rows", 0, n - 1),
        "pair": ("rows", philox.PAIR_BLOCK, philox.PAIR_BLOCK + n - 1),
        "normal": ("rows", philox.NORMAL_BLOCK, philox.NORMAL_BLOCK + k - 1),
        "pick": ("rows", philox.PICK_BLOCK, philox.PICK_BLOCK + k - 1),
        "subsample": ("rows", philox.SUBSAMPLE_BLOCK,
                      philox.SUBSAMPLE_BLOCK + n - 1),
        "dez": ("rows", philox.DEZ_BLOCK, philox.DEZ_BLOCK + k - 1),
        "dime": ("rows", philox.DIME_BLOCK, philox.DIME_BLOCK + k - 1),
        "chi2": ("rows", philox.CHI2_BLOCK, philox.CHI2_BLOCK + k - 1),
        "slice": ("rows", philox.SLICE_BLOCK, philox.SLICE_BLOCK + k - 1),
        "shrink": ("rows", philox.SHRINK_BLOCK,
                   philox.SHRINK_BLOCK + philox.SHRINK_MAX - 1),
        "roll": (philox.ROLL_LANE, 0, n - 1),
        "blend": (philox.ROLL_LANE, BLEND_BLOCK, BLEND_BLOCK + n - 1),
        # sub_seed's counters (at offset 2**64 - 1, besides)
        "blend keys": ("rows", BLEND_BLOCK | 0xFFFFF, BLEND_BLOCK | 0xFFFFF),
        "move": (philox.MOVE_LANE, 0, philox.MOVE_BLOCK),
    }


def test_philox_counter_blocks_are_disjoint():
    """No two blocks share a counter: on the same lanes their split
    words never meet, and every split word fits 32 bits."""
    blocks = _block_ranges()
    for name, (_, lo, hi) in blocks.items():
        assert 0 <= lo <= hi < 1 << 32, name
    names = sorted(blocks)
    for a in names:
        for b in names:
            la, lo_a, hi_a = blocks[a]
            lb, lo_b, hi_b = blocks[b]
            if a >= b or la != lb:
                continue
            assert hi_a < lo_b or hi_b < lo_a, (a, b)
    # The extension blocks: bit 27, and none of the older blocks' bits.
    for name in ("dez", "dime", "chi2", "slice", "shrink", "blend"):
        lo, hi = blocks[name][1:]
        for w in (lo, hi):
            assert w & philox.EXT_BLOCK and not w & 0xF0000000, name
    # Sub-move keys: distinct from the seed and from one another, fixed.
    keys = {sub_seed(5, k) for k in range(4)}
    assert len(keys) == 4 and 5 not in keys
    assert sub_seed(5, 1) == sub_seed(5, 1)
    assert all(0 <= k < 1 << 64 for k in keys)


def test_normal_side():
    """The fast oracle of ``test_side.py``."""
    _test_normal(moves.SideMove(), nsteps=3000)


def test_blended_mixture():
    """The fast oracle of ``test_mixture.py``'s blended mixture."""
    _test_normal(blended(), ndim=3, nsteps=3000)


@pytest.mark.slow
def test_normal_side_roll_blocked():
    _test_normal(moves.SideMove(pair_mode="roll", randomize_split=False),
                 nsteps=3000)


@pytest.mark.slow
def test_uniform_side():
    _test_uniform(moves.SideMove())


@pytest.mark.slow
def test_blended_switch_mode():
    _test_normal(blended(mode="switch"), ndim=3, nsteps=3000)
