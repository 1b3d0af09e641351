"""The Gaussian, MH and blended moves on every rung of the port's tempered
ladder (``emcee_tpu_torch/moves/gaussian.py``, ``moves/mh.py``,
``moves/blended.py``), the counterpart of the JAX package's ``jax.vmap``
of a move over the rungs (``emcee_tpu/parallel/tempering.py:449-541``),
and K20, the blend's choice and select (``ops/blend_kernel.py``,
``csrc/blend_select.cu``).

Exact within the port: ``propose_rungs`` of ``GaussianMove`` (every mode
and covariance, a factor, tuned), ``MHMove`` (with and without a carry,
and a function that returns a new carry dict) and ``BlendedMove`` (select
and switch, blocked and shuffled, with user blobs) against each rung's
``propose`` under its own key, bit for bit; ``PTSampler`` proposing every
rung at once against the forced per-rung loop (the private ``_batched``
switch).  K20's plain version against ``jnp.stack(qs)[idx]`` of the JAX
package (``emcee_tpu/moves/blended.py:117-119``) under an injected choice,
exactly, and its drawn choice against ``BlendedMove.choice``, with a
uniform equal to a float32 CDF point.  JAX runs on the CPU
(tests/conftest.py).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu_torch import PTSampler, moves
from emcee_tpu_torch.chunk_graph import TemperedLogProb
from emcee_tpu_torch.model import Model, wrap_log_prob_fn
from emcee_tpu_torch.ops import blend_kernel as bk
from emcee_tpu_torch.ops.philox import (
    BLEND_BLOCK, ROLL_LANE, DeviceOffset, rung_keys, sub_keys, sub_seed,
    word_uniforms)
from emcee_tpu_torch.state import State
from tests.test_torch_mh_gaussian import philox_mh
from tests.test_torch_pt_de import carries_of, ll_blobs, lp_box

T, NW, ND = 3, 16, 2
BETAS = [1.0, 0.6, 0.25]


def seed_of(*parts):
    """A seed fixed by ``parts`` (Python's own string hash varies by run)."""
    return zlib.crc32(repr(parts).encode())


def model(betas=BETAS):
    """The tempered model of every rung (a ``(T,)`` ladder) or of one rung
    (a scalar beta); the likelihood's blobs ``(2 logL, x)`` ride along."""
    return Model(TemperedLogProb(wrap_log_prob_fn(ll_blobs),
                                 wrap_log_prob_fn(lp_box),
                                 torch.tensor(betas)), nwalkers=NW, ndim=ND)


def start(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(T, NW, ND)).astype(np.float32))
    lp, blobs = model().compute_log_prob(x)
    return State(x, lp.clone(), blobs=clone(blobs))


def clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return tuple(clone(t) for t in tree)


def leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in leaves(t)]


def rung_view(tree, r):
    if isinstance(tree, torch.Tensor):
        return tree[r]
    return tuple(rung_view(t, r) for t in tree)


class CountingMH(moves.MHMove):
    """An MH move with a carry: a proposal count and a running sum of the
    step's scale, updated in place, or returned as a new dict."""

    def __init__(self, new_dict=False):
        self.new_dict = new_dict
        super().__init__(self._proposal)

    def init_carry(self, nwalkers, ndim, device=None):
        return {"n": torch.zeros((), dtype=torch.int32, device=device),
                "s": torch.ones((), dtype=torch.float32, device=device)}

    def _proposal(self, rng, x, carry):
        q, f = philox_mh(rng, x)
        q = x + (q - x) * carry["s"]
        new = {"n": carry["n"] + 1, "s": carry["s"] * 0.9}
        if self.new_dict:
            return q, f, new
        for k, v in new.items():
            carry[k].copy_(v)
        return q, f, carry


FULL = np.array([[0.5, 0.2], [0.2, 0.3]])


def blend(**kw):
    return moves.BlendedMove([(moves.DEMove(), 0.5), (moves.SideMove(), 0.3),
                              (moves.StretchMove(), 0.2)], **kw)


MOVES = {
    "gaussian": lambda: moves.GaussianMove(0.5),
    "gaussian diag random factor": lambda: moves.GaussianMove(
        [0.3, 0.6], mode="random", factor=2.0),
    "gaussian sequential tuned": lambda: moves.GaussianMove(
        0.5, mode="sequential", tune_target=0.3),
    "gaussian full tuned": lambda: moves.GaussianMove(FULL, tune_target=0.3),
    "mh": lambda: moves.MHMove(philox_mh),
    "mh carry": CountingMH,
    "mh new dict": lambda: CountingMH(new_dict=True),
    "blend": blend,
    "blend blocked switch": lambda: blend(mode="switch",
                                          randomize_split=False),
    "blend de snooker blocked": lambda: moves.BlendedMove(
        [(moves.DEMove(pair_mode="roll"), 0.8),
         (moves.DESnookerMove(pair_mode="roll", nsplits=2), 0.2)],
        randomize_split=False),
}


def ladder_carry(mv, gen):
    """The move's carry with a leading ``T`` axis, each rung's own."""
    c = mv.init_carry(NW, ND)
    if not isinstance(c, dict):
        return c
    out = {}
    for k, v in c.items():
        v = v.unsqueeze(0).repeat((T,) + (1,) * v.dim())
        if k == "log_adj":
            v = 0.4 * torch.randn(T, generator=gen)
        elif k == "index":
            v = torch.tensor([0, 1, 3], dtype=torch.int32)
        elif k == "s":
            v = 0.5 + torch.rand(T, generator=gen)
        out[k] = v
    return out


@pytest.mark.parametrize("name", list(MOVES))
@pytest.mark.parametrize("offset_kind", ["int", "device word"])
def test_propose_rungs_equals_each_rung_alone(name, offset_kind):
    """One proposal of every rung at once against each rung's ``propose``
    under its own key: coordinates, log-probs, blobs, acceptance, counts
    and carries, bit for bit."""
    gen = torch.Generator().manual_seed(seed_of(name) % 2**31)
    mv = MOVES[name]()
    assert mv.rung_batched
    keys = rung_keys(23, T, "cpu")
    off, off_int = ((DeviceOffset(torch.tensor(4, dtype=torch.int64), 5), 9)
                    if offset_kind == "device word" else (9, 9))
    st = start(seed_of(name) % 1000)
    carry = ladder_carry(mv, gen)
    init = (clone(st.coords), clone(st.log_prob), clone(st.blobs))
    init_carry = ({k: v.clone() for k, v in carry.items()}
                  if isinstance(carry, dict) else carry)
    count = torch.zeros((T, NW), dtype=torch.int32)
    acc = torch.empty((T, NW), dtype=torch.bool)
    mv.propose_rungs((keys, off), st, model(), carry, count, accepted=acc)
    assert 0 < int(acc.sum()) < T * NW
    for r in range(T):
        st_r = State(init[0][r].clone(), init[1][r].clone(),
                     clone(rung_view(init[2], r)))
        c_r = ({k: v[r].clone() for k, v in init_carry.items()}
               if isinstance(init_carry, dict) else init_carry)
        n_r = torch.zeros(NW, dtype=torch.int32)
        a_r = torch.empty(NW, dtype=torch.bool)
        mv.propose((keys.seeds[r], off_int), st_r, model(BETAS[r]), c_r,
                   n_r, accepted=a_r)
        assert torch.equal(st_r.coords, st.coords[r]), r
        assert torch.equal(st_r.log_prob, st.log_prob[r]), r
        for a, b in zip(leaves(st_r.blobs), leaves(rung_view(st.blobs, r))):
            assert torch.equal(a, b), r
        assert torch.equal(a_r, acc[r]) and torch.equal(n_r, count[r]), r
        if isinstance(c_r, dict):
            for k in c_r:
                assert torch.equal(c_r[k], carry[k][r]), (r, k)


@pytest.mark.parametrize("name,tune", [
    ("gaussian", False), ("gaussian diag random factor", False),
    ("gaussian sequential tuned", True), ("gaussian full tuned", True),
    ("mh", False), ("mh carry", False), ("mh new dict", False),
    ("blend", False), ("blend blocked switch", False),
])
def test_batched_path_equals_the_per_rung_loop(name, tune):
    """``PTSampler`` proposing every rung at once (K19 or the function a
    rung at a time, or the sub-moves and K20; one log-prob over ``T * n``
    rows; K2's rung kernel) against the forced per-rung loop, bit for bit:
    chain, logL, logP, the blobs ``(2 logL, x)``, acceptance, swaps,
    random state and the carries."""
    ends = []
    for batched in (True, False):
        s = PTSampler(T, NW, ND, ll_blobs, lp_box, moves=MOVES[name](),
                      seed=13, device="cpu")
        s._batched = batched
        p0 = np.random.default_rng(3).normal(size=(T, NW, ND))
        s.run_mcmc(p0, 5, thin_by=2, tune=tune)
        s.run_mcmc(None, 3, tune=tune)
        blobs = s.get_blobs()
        ends.append((s.get_chain(), s.get_log_like(), s.get_log_prior(),
                     np.asarray(blobs[0]), np.asarray(blobs[1]),
                     s.backend.accepted, s.swaps_accepted, s.swaps_proposed,
                     s.backend.random_state, carries_of(s)))
    for x, y in zip(ends[0][:-1], ends[1][:-1]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert 0 < ends[0][5].sum() < 13 * T * NW
    for a, b in zip(ends[0][-1], ends[1][-1]):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            assert all(torch.equal(a[k], b[k]) for k in a)


def test_sub_keys_are_each_rungs_sub_seed():
    keys = rung_keys(99, 4, "cpu")
    for k in range(3):
        sk = sub_keys(keys, k)
        assert sk.seeds == tuple(sub_seed(s, k) for s in keys.seeds)
        assert sk.seeds[0] == sub_seed(99, k)
        assert torch.equal(sk.table, torch.tensor(
            [s - (1 << 64) if s >= 1 << 63 else s for s in sk.seeds]))


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("scalar_factor", [False, True])
def test_k20_plain_matches_jax_stack_select(lead, scalar_factor):
    """Under an injected choice (a rung's own on the rung axis), K20's
    plain version is ``jnp.stack(qs)[idx]`` and ``jnp.stack(fs)[idx]``
    exactly; a factor of one value broadcasts as ``jnp.broadcast_to``;
    a choice outside the sub-moves selects sub-move 0."""
    rng = np.random.default_rng(7)
    k, ng, nd = 4, 6, 3
    qs = [rng.normal(size=lead + (ng, nd)).astype(np.float32)
          for _ in range(k)]
    fs = [np.float32(rng.normal()) if scalar_factor and j % 2 else
          rng.normal(size=lead + (ng,)).astype(np.float32) for j in range(k)]
    choices = [np.array([2, 0, 3]), np.array([1, 3, 2])] if lead else [
        np.array(j) for j in range(k)]
    for idx in choices:
        q, f = bk.blend_select_plain(
            [torch.from_numpy(a) for a in qs],
            [torch.tensor(a) for a in fs], [0.1, 0.2, 0.3], 0, 0, 0,
            choice=torch.from_numpy(idx))
        jfs = [jnp.broadcast_to(jnp.asarray(a), lead + (ng,)) for a in fs]
        if lead:
            for r in range(lead[0]):
                jq = jnp.stack([jnp.asarray(a[r]) for a in qs])[idx[r]]
                jf = jnp.stack([a[r] for a in jfs])[idx[r]]
                np.testing.assert_array_equal(q[r].numpy(), np.asarray(jq))
                np.testing.assert_array_equal(f[r].numpy(), np.asarray(jf))
        else:
            jq = jnp.stack([jnp.asarray(a) for a in qs])[idx]
            jf = jnp.stack(jfs)[idx]
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    q, _ = bk.blend_select_plain([torch.from_numpy(a) for a in qs],
                                 [torch.tensor(a) for a in fs],
                                 [0.1, 0.2, 0.3], 0, 0, 0, choice=k + 1)
    assert torch.equal(q, torch.from_numpy(qs[0]))


def test_k20_choice_at_a_float32_cdf_point():
    """The choice compares a float32 uniform with the CDF points as float32
    (``u >= c`` of a float32 tensor and a Python float): at ``u`` equal to
    float32(0.7), which is below 0.7, the point counts, as
    ``BlendedMove.choice`` counts it; the drawn choice of every split is
    ``BlendedMove.choice`` of the split's uniform, on every rung."""
    bl = moves.BlendedMove([(moves.DEMove(), 0.3), (moves.SideMove(), 0.4),
                            (moves.StretchMove(), 0.3)])
    assert bl._cdf[1] == pytest.approx(0.7) and float(np.float32(0.7)) < 0.7
    pts = np.float32(bl._cdf)
    u = torch.tensor(np.concatenate([
        pts, np.nextafter(pts, np.float32(0)), np.nextafter(pts,
                                                            np.float32(1))]))
    want = (u.numpy()[:, None] >= pts[None, :]).sum(axis=1)
    assert torch.equal(bl.choice(u), torch.from_numpy(want))
    assert torch.equal(bk.blend_choice(u, bl._cdf), torch.from_numpy(want))
    assert int(bl.choice(torch.tensor([np.float32(0.7)]))[0]) == 2
    keys = rung_keys(4, T, "cpu")
    ng = NW // 2
    q = [torch.full((T, ng, ND), float(j)) for j in range(3)]
    f = [torch.full((T, ng), float(j)) for j in range(3)]
    for split in (0, 1):
        for off in (0, 5, 2**33 + 7):
            got, gf = bk.blend_select(q, f, bl._cdf, keys, off, split)
            for r in range(T):
                u = word_uniforms(1, 1, BLEND_BLOCK | split, keys.seeds[r],
                                  off, "cpu", row0=ROLL_LANE)[0, 0]
                c = int(bl.choice(u))
                assert torch.equal(got[r], q[c][r]) and torch.equal(
                    gf[r], f[c][r])
                one, _ = bk.blend_select([t[r] for t in q], [t[r] for t in f],
                                         bl._cdf, keys.seeds[r], off, split)
                assert torch.equal(one, got[r])
