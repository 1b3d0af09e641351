"""The side and walk moves on every rung of the port's tempered ladder:
K5a's side mode, K8a with K8b's walk mode, K18a and K18b with the rung
axis (``emcee_tpu_torch/moves/side.py``, ``moves/walk.py``), the
counterpart of the JAX package's ``jax.vmap`` of a move over the rungs
(``emcee_tpu/parallel/tempering.py:449-541``).

Against the JAX package, rung by rung: K5a's side mode on the rung axis
against ``SideMove.get_proposal`` under each rung's own key, whose draws
are reproduced (``tests/test_torch_side_blended.py`` ``jax_side_draws``)
and injected as ``(T, ng)`` rows; the shared walk on the rung axis against
``WalkMove.get_proposal`` under each rung's key's normals (rtol = atol =
1e-5).  Exact within the port: ``PTSampler`` proposing every rung at once
against the forced per-rung loop (the private ``_batched`` switch), bit
for bit, with user blobs and tuning.  JAX runs on the CPU
(tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu.model import Model as JModel
from emcee_tpu.moves import SideMove as JSideMove
from emcee_tpu.moves import WalkMove as JWalkMove

from emcee_tpu_torch import PTSampler, moves
from emcee_tpu_torch.model import Model
from emcee_tpu_torch.ops.philox import rung_keys
from tests.test_torch_pt_de import carries_of, ll_blobs, lp_box, rung_parts
from tests.test_torch_side_blended import RTOL as SIDE_RTOL
from tests.test_torch_side_blended import jax_side_draws

WALK_TOL = 1e-5  # tests/test_torch_walk_kde.py


def stack(draws):
    """One ``(T, ...)`` tensor of each keyword of the rungs' draws."""
    return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}


@pytest.mark.parametrize("pair_mode", ["roll", "random"])
@pytest.mark.parametrize("tuned", [False, True])
def test_side_rung_axis_matches_jax_get_proposal(pair_mode, tuned):
    rng = np.random.default_rng(80 + tuned)
    T, nw, nd = 3, 24, 4
    ng = nw // 2
    coords = rng.normal(size=(T, nw, nd)).astype(np.float32)
    scale = np.array([0.7, 1.3, 1.0], np.float32) if tuned else None
    jmove = JSideMove(pair_mode=pair_mode)
    jmodel = JModel(compute_log_prob=None, nwalkers=nw)
    model = Model(None, nw, nd)
    for split in (0, 1):
        keys = [jax.random.key(500 + 10 * r + split) for r in range(T)]
        q, f = moves.SideMove(pair_mode=pair_mode).get_proposal(
            (rung_keys(0, T, "cpu"), 0), torch.tensor(coords), split, model,
            extra=stack([jax_side_draws(k, pair_mode, ng, nw - ng)
                         for k in keys]),
            scale=None if scale is None else torch.tensor(scale))
        assert q.shape == (T, ng, nd) and not f.any()
        for r in range(T):
            s, c_parts = rung_parts(coords, r, split, 2)
            kw = {} if scale is None else dict(scale=jnp.float32(scale[r]))
            jq, _ = jmove.get_proposal(keys[r], s, c_parts, jmodel, **kw)
            np.testing.assert_allclose(q[r].numpy(), np.asarray(jq),
                                       SIDE_RTOL, SIDE_RTOL)


@pytest.mark.parametrize("tuned", [False, True])
def test_shared_walk_rung_axis_matches_jax_get_proposal(tuned):
    """Each rung's factor from its own complement, its own normals and
    scale."""
    rng = np.random.default_rng(90 + tuned)
    T, nw, nd = 3, 40, 3
    ng = nw // 2
    coords = rng.normal(size=(T, nw, nd)).astype(np.float32)
    coords *= np.array([1.0, 2.0, 0.5], np.float32)[:, None, None]
    scale = np.array([0.7, 1.3, 1.0], np.float32) if tuned else None
    jmodel = JModel(compute_log_prob=None, nwalkers=nw)
    for split in (0, 1):
        keys = [jax.random.key(600 + 10 * r + split) for r in range(T)]
        z = torch.stack([torch.from_numpy(np.array(jax.random.normal(
            k, (ng, nd), dtype=jnp.float32))) for k in keys])
        q, f = moves.WalkMove().get_proposal(
            (rung_keys(0, T, "cpu"), 0), torch.tensor(coords), split,
            Model(None, nw, nd), extra={"z": z},
            scale=None if scale is None else torch.tensor(scale))
        assert q.shape == (T, ng, nd) and not f.any()
        for r in range(T):
            s, c_parts = rung_parts(coords, r, split, 2)
            kw = {} if scale is None else dict(scale=jnp.float32(scale[r]))
            jq, _ = JWalkMove().get_proposal(keys[r], s, c_parts, jmodel,
                                             **kw)
            np.testing.assert_allclose(q[r].numpy(), np.asarray(jq),
                                       WALK_TOL, WALK_TOL)


@pytest.mark.parametrize("make,tune", [
    (lambda: moves.SideMove(), False),
    (lambda: moves.SideMove(pair_mode="roll", randomize_split=False), False),
    (lambda: moves.SideMove(tune_target=0.3), True),
    (lambda: moves.WalkMove(), False),
    (lambda: moves.WalkMove(tune_target=0.3), True),
    (lambda: moves.WalkMove(s=3), False),
    (lambda: moves.WalkMove(s=3, exact_subset_max=4, randomize_split=False,
                            tune_target=0.3), True),
])
def test_batched_path_equals_the_per_rung_loop(make, tune):
    """Every rung at once (K5a's side mode, or K8a, K8b and K18a, or K18b,
    and K2 with the rung axis; the log-prob over ``T * ng`` rows) against
    the forced per-rung loop, bit for bit: chain, logL, logP, the blobs
    ``(2 logL, x)``, acceptance, swaps, random state and the tuned
    carries; the box prior rejects some proposals."""
    ends = []
    for batched in (True, False):
        s = PTSampler(3, 16, 2, ll_blobs, lp_box, moves=make(), seed=11,
                      device="cpu")
        s._batched = batched
        start = np.random.default_rng(2).normal(size=(3, 16, 2))
        s.run_mcmc(start, 6, thin_by=2, tune=tune)
        s.run_mcmc(None, 4, tune=tune)
        blobs = s.get_blobs()
        ends.append((s.get_chain(), s.get_log_like(), s.get_log_prior(),
                     np.asarray(blobs[0]), np.asarray(blobs[1]),
                     s.backend.accepted, s.swaps_accepted, s.swaps_proposed,
                     s.backend.random_state, carries_of(s)))
    for x, y in zip(ends[0][:-1], ends[1][:-1]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert 0 < ends[0][5].sum() < 16 * 3 * 16
    for a, b in zip(ends[0][-1], ends[1][-1]):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            assert all(torch.equal(a[k], b[k]) for k in a)
    if tune:
        assert int(ends[0][-1][0]["t"][0]) == 16
        assert not torch.equal(ends[0][-1][0]["log_adj"], torch.zeros(3))
