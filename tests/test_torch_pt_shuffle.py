"""The shuffled split through K16 and K17's plain versions against the JAX
package, on one ensemble and on every rung of a ladder.

``emcee_tpu``'s ``RedBlueMove._propose_shuffled``
(``emcee_tpu/moves/red_blue.py:211-276``) draws its permutation with
``jax.random.permutation``; the port defines its own (the stable argsort
of Philox word 3, ``ROADMAP.md`` section 3).  So the test hands JAX the
port's permutation (``jax.random.permutation`` monkeypatched) and both
packages the same injected accept and stretch uniforms, and runs the
port's route: K16's order, K17's gather, the blocked engine, K17's
scatter (``emcee_tpu_torch/moves/red_blue.py`` ``_propose_shuffled``).
Coordinates, log-probs and blobs agree to float32 rounding (rtol 1e-5,
atol 1e-6, as ``tests/test_torch_moves.py``) and the acceptance exactly:
one ensemble with blobs, and each rung of a 3-rung ladder against JAX's
one-ensemble step at that rung's permutation.  Within the port, bit for
bit: ``PTSampler`` proposing every rung at once against the forced
per-rung loop (the private ``_batched`` switch), with
``StretchMove()`` and with ``EnsembleSliceMove()``.  JAX runs on the CPU
(tests/conftest.py).
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

from emcee_tpu_torch import PTSampler, moves
from emcee_tpu_torch.model import Model
from emcee_tpu_torch.ops.philox import rung_keys, rung_words, walker_words
from emcee_tpu_torch.state import State

RTOL, ATOL = 1e-5, 1e-6


def port_lp(q):
    lp = -0.5 * (q**2).sum(-1)
    return lp, {"a": 2.0 * lp, "v": q[..., :2].to(torch.float64)}


def jax_lp(q):
    lp = -0.5 * jnp.sum(q**2, axis=-1)
    return lp, {"a": 2.0 * lp, "v": q[..., :2]}


def jax_step(monkeypatch, perm, nsplits, coords, lp, blobs, log_acc_u,
             extra_u):
    """JAX's shuffled stretch proposal (roll pairs) at permutation
    ``perm`` under the injected uniforms."""
    nw = coords.shape[0]
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, n: jnp.asarray(perm))
    jmove = JStretchMove(nsplits=nsplits, pair_mode="roll")
    jmodel = JModel(compute_log_prob=jax_lp, nwalkers=nw)
    key = jax.random.key(0)
    st = JState(jnp.asarray(coords), jnp.asarray(lp),
                {k: jnp.asarray(v) for k, v in blobs.items()})
    return jmove._propose_shuffled(
        key, jax.random.split(key, nsplits), jnp.asarray(log_acc_u),
        jnp.asarray(extra_u), st, jmodel, (), nw // nsplits)


def check_rung(new, acc, jnew, jacc):
    coords, lp, blobs = new
    np.testing.assert_array_equal(acc, np.asarray(jacc))
    np.testing.assert_allclose(coords, np.asarray(jnew.coords), RTOL, ATOL)
    np.testing.assert_allclose(lp, np.asarray(jnew.log_prob), RTOL, ATOL)
    for k in ("a", "v"):
        np.testing.assert_allclose(blobs[k], np.asarray(jnew.blobs[k]),
                                   RTOL, ATOL)


def start(rng, shape):
    coords = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    lp, blobs = port_lp(coords)
    return coords, lp, blobs


def uniforms(rng, lead, nsplits, ng):
    log_u = np.log(rng.uniform(size=(nsplits, *lead, ng))).astype(np.float32)
    extra = rng.uniform(size=(nsplits, *lead, ng + 1)).astype(np.float32)
    return log_u, extra


@pytest.mark.parametrize("nsplits", [2, 3])
def test_one_ensemble_with_blobs_matches_jax(monkeypatch, nsplits):
    rng = np.random.default_rng(80 + nsplits)
    nw, nd, seed = 24, 3, 12345
    ng = nw // nsplits
    coords, lp, blobs = start(rng, (nw, nd))
    model = Model(compute_log_prob=port_lp, nwalkers=nw, ndim=nd)
    move = moves.StretchMove(nsplits=nsplits, pair_mode="roll")
    count = torch.zeros(nw, dtype=torch.int32)
    for offset in range(4):
        log_u, extra = uniforms(rng, (), nsplits, ng)
        w3 = walker_words(nw, nsplits, seed, offset, "cpu", word=3)
        perm = torch.argsort(w3, stable=True).numpy()
        jnew, jacc, _ = jax_step(monkeypatch, perm, nsplits,
                                 coords.numpy().copy(), lp.numpy().copy(),
                                 {k: v.numpy().copy()
                                  for k, v in blobs.items()}, log_u, extra)
        before = count.clone()
        st, acc, _ = move._propose_shuffled(
            (seed, offset), State(coords, lp, blobs), model, (), ng,
            acc_count=count, log_acc_u=torch.from_numpy(log_u),
            extra_u=torch.from_numpy(extra))
        check_rung((st.coords.numpy(), st.log_prob.numpy(),
                    {k: v.numpy() for k, v in st.blobs.items()}),
                   acc.numpy(), jnew, jacc)
        assert torch.equal(count - before, acc.to(torch.int32))
        assert 0 < int(acc.sum()) < nw
        coords, lp, blobs = st.coords, st.log_prob, st.blobs


def test_each_rung_matches_jax_at_its_permutation(monkeypatch):
    rng = np.random.default_rng(90)
    T, nw, nd, nsplits, seed = 3, 24, 3, 2, 777
    ng = nw // nsplits
    keys = rung_keys(seed, T, "cpu")
    coords, lp, blobs = start(rng, (T, nw, nd))
    model = Model(compute_log_prob=port_lp, nwalkers=nw, ndim=nd)
    move = moves.StretchMove(pair_mode="roll")
    for offset in (0, 5):
        log_u, extra = uniforms(rng, (T,), nsplits, ng)
        w3 = rung_words(keys, nw, nsplits, offset, "cpu", word=3)
        perms = torch.argsort(w3, dim=-1, stable=True).numpy()
        old = (coords.numpy().copy(), lp.numpy().copy(),
               {k: v.numpy().copy() for k, v in blobs.items()})
        st, acc, _ = move._propose_shuffled(
            (keys, offset), State(coords, lp, blobs), model, (), ng,
            log_acc_u=torch.from_numpy(log_u),
            extra_u=torch.from_numpy(extra))
        assert st.coords.shape == (T, nw, nd) and acc.shape == (T, nw)
        for r in range(T):
            jnew, jacc, _ = jax_step(
                monkeypatch, perms[r], nsplits, old[0][r], old[1][r],
                {k: v[r] for k, v in old[2].items()}, log_u[:, r],
                extra[:, r])
            check_rung((st.coords[r].numpy(), st.log_prob[r].numpy(),
                        {k: v[r].numpy() for k, v in st.blobs.items()}),
                       acc[r].numpy(), jnew, jacc)
        assert not np.array_equal(perms[0], perms[1])
        coords, lp, blobs = st.coords, st.log_prob, st.blobs


def ll_blobs(x):
    ll = -0.5 * torch.sum((x - 1.0) ** 2)
    return ll, 2.0 * ll, x


def lp_box(x):
    return torch.where(torch.all(torch.abs(x) < 4.0), 0.0, -torch.inf)


@pytest.mark.parametrize("make", [
    lambda: moves.StretchMove(),
    lambda: moves.StretchMove(nsplits=3),
    lambda: moves.EnsembleSliceMove(),
    lambda: [(moves.StretchMove(), 0.6), (moves.EnsembleSliceMove(), 0.4)],
])
def test_batched_path_equals_the_per_rung_loop(make):
    """Every rung at once against the forced per-rung loop, bit for bit:
    chain, logL, logP, the blobs ``(2 logL, x)``, acceptance, swaps and
    random state (the slice move loops over the rungs on both paths, its
    shuffle one rung's segment at a time)."""
    ends = []
    for batched in (True, False):
        s = PTSampler(3, 18, 2, ll_blobs, lp_box, moves=make(), seed=21,
                      device="cpu")
        s._batched = batched
        p0 = np.random.default_rng(4).normal(size=(3, 18, 2))
        s.run_mcmc(p0, 5, thin_by=2)
        s.run_mcmc(None, 3)
        blobs = s.get_blobs()
        ends.append((s.get_chain(), s.get_log_like(), s.get_log_prior(),
                     np.asarray(blobs[0]), np.asarray(blobs[1]),
                     s.backend.accepted, s.swaps_accepted, s.swaps_proposed,
                     s.backend.random_state))
    for x, y in zip(*ends):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert 0 < ends[0][5].sum() < 13 * 3 * 18
