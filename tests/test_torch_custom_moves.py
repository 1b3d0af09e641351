"""User-defined moves through both extension points of the port, the twin
of ``tests/integration/test_custom_moves.py``: a custom ``MHMove``
proposal function (two and three arguments) and a ``RedBlueMove``
subclass written as ``docs/moves.md`` ("Writing your own move") shows
it, ``get_proposal(key, s, c_parts, model)``, with torch and the port's
Philox helpers in place of ``jax.random``, each held to the normal
oracle of ``tests/test_torch_sampler.py``.  Also: the hook's keywords
(only those set, as ``emcee_tpu/moves/red_blue.py:188-195`` passes
them), its groups and keys, the built-in moves' own hook, a user move
inside a ``BlendedMove`` and on a ladder, and the backends' ``__all__``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import emcee_tpu_torch
from emcee_tpu_torch import moves
from emcee_tpu_torch.model import Model, wrap_log_prob_fn
from emcee_tpu_torch.moves.red_blue import shuffled_order
from emcee_tpu_torch.ops.philox import normals, row_uniforms, split_seed
from emcee_tpu_torch.state import State
from tests.test_torch_sampler import _test_normal, normal_log_prob


class MyStretch(moves.RedBlueMove):
    """The docs example: a from-scratch Goodman-Weare stretch, drawing its
    partner and ``z`` uniforms under the group's ``(seed, offset)``."""

    def __init__(self, a=2.0, **kwargs):
        self.a = a
        super().__init__(**kwargs)

    def get_proposal(self, key, s, c_parts, model):
        seed, offset = key
        c = torch.cat(c_parts, dim=0)
        u = row_uniforms(s.shape[0], 2, seed, offset, s.device,
                         dtype=s.dtype)
        pick = (u[:, 0] * c.shape[0]).long().clamp_(max=c.shape[0] - 1)
        partners = c[pick]
        z = ((self.a - 1.0) * u[:, 1] + 1.0) ** 2 / self.a
        q = partners - z[:, None] * (partners - s)
        return q, (model.global_ndim(s.shape[1]) - 1.0) * torch.log(z)


class Recorder(moves.RedBlueMove):
    """A JAX-shaped move that keeps what its hook was given and proposes
    its group unchanged."""

    def __init__(self, carry=False, **kwargs):
        self.wants_carry = carry
        self.calls = []
        super().__init__(**kwargs)

    def get_proposal(self, key, s, c_parts, model, **kw):
        self.calls.append((key, s.clone(), [c.clone() for c in c_parts],
                           dict(kw)))
        return s.clone(), torch.zeros(s.shape[0], dtype=torch.float64)


def ensemble(nw=12, nd=2, seed=0):
    x = np.random.default_rng(seed).normal(size=(nw, nd))
    lp = -0.5 * (x**2).sum(-1)
    return State(torch.from_numpy(x), torch.from_numpy(lp))


def model():
    return Model(wrap_log_prob_fn(normal_log_prob), 12, 2)


def test_custom_red_blue_subclass():
    _test_normal(MyStretch(), ndim=3, nsteps=2000)


def test_custom_move_in_mixture():
    """Custom moves compose with the mixture machinery like built-ins."""
    _test_normal([(MyStretch(), 0.5), (moves.DEMove(), 0.5)], ndim=2,
                 nsteps=2000)


def test_custom_mh_proposal():
    def my_proposal(rng, coords):
        seed, offset = rng
        z = normals(*coords.shape, seed, offset, coords.device,
                    dtype=coords.dtype)
        return coords + 0.7 * z, torch.zeros(coords.shape[0])

    _test_normal(moves.MHMove(my_proposal), nsteps=4000)


@pytest.mark.slow
def test_custom_mh_proposal_with_carry():
    """Three arguments: the move's carry threads through the run."""

    def my_proposal(rng, coords, carry):
        seed, offset = rng
        step = torch.where(carry["t"] % 2 == 0, 0.5, 0.9)
        z = normals(*coords.shape, seed, offset, coords.device,
                    dtype=coords.dtype)
        q = coords + step * z
        return q, torch.zeros(coords.shape[0]), {"t": carry["t"] + 1}

    mv = moves.MHMove(my_proposal)
    mv.init_carry = lambda nw, nd, device=None: {
        "t": torch.zeros((), dtype=torch.int32, device=device)}
    _test_normal(mv, nsteps=4000)


@pytest.mark.parametrize("randomize_split", [False, True])
@pytest.mark.parametrize("nsplits", [2, 3])
def test_hook_gets_its_group_the_others_and_no_unset_keyword(
        randomize_split, nsplits):
    """``s`` is the group, ``c_parts`` the other groups in group order
    (contiguous blocks, or the shuffled split's groups), ``key`` the
    group's own seed with the proposal's offset, and no ``extra=`` /
    ``scale=`` reaches the hook unless set."""
    st = ensemble()
    x0 = st.coords.clone()
    mv = Recorder(nsplits=nsplits, randomize_split=randomize_split)
    seed, offset = 77, 5
    _, acc, _ = mv.propose((seed, offset), st, model(), ())
    assert acc.all() and torch.equal(st.coords, x0)
    ng = 12 // nsplits
    if randomize_split:
        order = shuffled_order((seed, offset), 12, nsplits, "cpu")
    else:
        order = torch.arange(12)
    groups = [x0[order[j * ng:(j + 1) * ng]] for j in range(nsplits)]
    assert len(mv.calls) == nsplits
    for j, (key, s, c_parts, kw) in enumerate(mv.calls):
        assert key == (split_seed(seed, j), offset) and kw == {}
        assert torch.equal(s, groups[j])
        others = [groups[k] for k in range(nsplits) if k != j]
        assert len(c_parts) == nsplits - 1
        assert all(torch.equal(a, b) for a, b in zip(c_parts, others))


def test_hook_gets_extra_scale_and_carry_only_when_set():
    st = ensemble()
    mv = Recorder(carry=True, randomize_split=False)
    carry = {"k": torch.zeros(1)}
    mv._propose_blocked((3, 4), st, model(), carry, 6, scale=None,
                        extra_u=torch.ones(2, 1))
    mv._propose_blocked((3, 4), st, model(), carry, 6,
                        scale=torch.tensor(0.5))
    first, second = [c[3] for c in mv.calls[:2]], [c[3] for c in
                                                    mv.calls[2:]]
    assert all(set(kw) == {"carry", "extra"} and kw["carry"] is carry
               for kw in first)
    assert all(set(kw) == {"carry", "scale"} for kw in second)


def test_builtin_moves_keep_their_hook_and_user_moves_loop_rungs():
    for cls in (moves.StretchMove, moves.DEMove, moves.DESnookerMove,
                moves.SideMove, moves.WalkMove, moves.KDEMove,
                moves.DIMEMove, moves.DEZMove, moves.BlendedMove,
                moves.EnsembleSliceMove):
        assert cls._jax_hook is False
    assert moves.StretchMove().rung_batched

    class Subclassed(moves.StretchMove):  # inherits the port's hook
        pass

    assert Subclassed._jax_hook is False and Subclassed().rung_batched
    assert MyStretch._jax_hook is True and not MyStretch().rung_batched
    blend = moves.BlendedMove([MyStretch(), moves.StretchMove()])
    assert not blend.rung_batched


def test_custom_move_in_a_blend_and_on_a_ladder():
    """A user move as a ``BlendedMove``'s sub-move (under its sub-move key)
    and on a ``PTSampler``'s ladder (rung by rung)."""
    p0 = np.random.default_rng(2).normal(size=(16, 2))
    blend = moves.BlendedMove([(MyStretch(), 0.5), (moves.DEMove(), 0.5)])
    s = emcee_tpu_torch.EnsembleSampler(16, 2, normal_log_prob, moves=blend,
                                        seed=3, device="cpu")
    s.run_mcmc(p0, 50)
    assert np.isfinite(s.get_chain()).all()
    assert 0.1 < s.acceptance_fraction.mean() < 0.95
    pt = emcee_tpu_torch.PTSampler(
        3, 16, 2, normal_log_prob, lambda x: torch.zeros(()), seed=4,
        device="cpu", moves=MyStretch())
    pt.run_mcmc(np.random.default_rng(5).normal(size=(3, 16, 2)), 50)
    assert np.isfinite(pt.get_chain()).all()
    assert 0.1 < pt.acceptance_fraction.mean() < 0.95


def test_backends_star_import_binds_pt_and_matches_the_jax_package():
    import emcee_tpu.backends
    import emcee_tpu_torch.backends

    ns = {}
    exec("from emcee_tpu_torch.backends import *", ns)
    assert ns["pt"] is emcee_tpu_torch.backends.pt
    assert (set(emcee_tpu.backends.__all__) - {"merge_shards"}
            == set(emcee_tpu_torch.backends.__all__))
