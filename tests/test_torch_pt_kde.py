"""``KDEMove`` on every rung of the port's tempered ladder: K7 with the rung
axis (``emcee_tpu_torch/ops/kde_kernel.py``) under ``KDEMove``
(``moves/kde.py``, ``rung_batched``), the counterpart of the JAX
package's ``jax.vmap`` of the move over the rungs
(``emcee_tpu/parallel/tempering.py:532-541``).

Against the JAX package, rung by rung: each rung's Hastings factor of the
rung-axis proposal against ``emcee_tpu.moves.KDEMove._logpdf`` of the
rung's group, proposal, complement and factor (rtol = atol = 1e-4, as
``tests/test_torch_walk_kde.py``).  Within the port: each rung's draws on
the rung axis (the subsample keys, the kernel centres, the noise) equal
its one-ensemble draws under its own key bit for bit; ``propose_rungs``
and ``PTSampler`` proposing every rung at once against each rung alone and
the forced per-rung loop (the private ``_batched`` switch).  Every rung's
complement covariance, Cholesky factor and product by it are batched
products there, which on the CPU may round otherwise than each rung's own
``mm`` (``ROADMAP.md`` section 3): the batched path is held to the loop at
rtol = atol = 1e-5 with the same acceptance and swaps.  Then a statistical
oracle: the cold rung's moments under a tempered ``KDEMove()``.  JAX runs
on the CPU (tests/conftest.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu import moves as jmoves

from emcee_tpu_torch import PTSampler, moves
from emcee_tpu_torch.chunk_graph import TemperedLogProb
from emcee_tpu_torch.model import Model, wrap_log_prob_fn
from emcee_tpu_torch.moves.walk import cholesky_or_nan, complement, cov
from emcee_tpu_torch.ops.philox import (
    SUBSAMPLE_BLOCK, DeviceOffset, normals, rung_keys, rung_words,
    walker_words, word_uniforms)
from emcee_tpu_torch.state import State

TOL = 1e-5  # the batched products against each rung's own
T, NW, ND = 3, 24, 2
BETAS = np.array([1.0, 0.5, 0.2], np.float32)


def like_t(x):
    return -0.5 * (x**2).sum(-1)


def prior_t(x):
    return -0.5 * (x**2).sum(-1) / 100.0


def port_model(betas=BETAS):
    """The port's tempered model of every rung (a ``(T,)`` ladder), or of
    one rung (a scalar ``betas``)."""
    return Model(TemperedLogProb(wrap_log_prob_fn(like_t, vectorize=True),
                                 wrap_log_prob_fn(prior_t, vectorize=True),
                                 torch.tensor(betas)), nwalkers=NW, ndim=ND)


def start(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(T, NW, ND)).astype(np.float32))
    lp, blobs = port_model().compute_log_prob(x)
    return State(x, lp.clone(), blobs=tuple(b.clone() for b in blobs))


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), tol, tol)


@pytest.mark.parametrize("max_complement", [None, 7])
@pytest.mark.parametrize("offset_kind", ["int", "device word"])
def test_rung_axis_draws_equal_each_rung_alone(max_complement, offset_kind):
    """The rung axis's subsample keys, kernel centres and noise are each
    rung's one-ensemble draws under its own key, bit for bit: the
    proposal from them, with the batched products, within ``TOL`` of the
    rung's own."""
    keys = rung_keys(31, T, "cpu")
    off, off_int = ((DeviceOffset(torch.tensor(4, dtype=torch.int64), 5), 9)
                    if offset_kind == "device word" else (9, 9))
    x = start(1).coords
    ng, split = NW // 2, 1
    nc = NW - ng
    mv = moves.KDEMove(max_complement=max_complement)
    q, f = mv.get_proposal((keys, off), x, split, port_model())
    assert q.shape == (T, ng, ND) and f.shape == (T, ng)
    for r in range(T):
        seed = keys.seeds[r]
        qr, fr = mv.get_proposal((seed, off_int), x[r], split,
                                 port_model(BETAS[r]))
        close(q[r], qr)
        close(f[r], fr)
        # the draws themselves
        u = word_uniforms(ng, 1, split, seed, off_int, "cpu")[:, 0]
        assert torch.equal(u, word_uniforms(ng, 1, split, keys, off,
                                            "cpu")[r, :, 0])
        z = normals(ng, ND, seed, off_int, "cpu", row0=split * ng)
        assert torch.equal(z, normals(ng, ND, keys, off, "cpu",
                                      row0=split * ng)[r])
        if max_complement is not None:
            w = walker_words(nc, SUBSAMPLE_BLOCK | split, seed, off_int,
                             "cpu", word=0)
            assert torch.equal(w, rung_words(keys, nc, SUBSAMPLE_BLOCK
                                             | split, off, "cpu",
                                             word=0)[r])


@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("max_complement", [None, 9])
def test_rung_axis_factors_match_jax_rung_by_rung(split, max_complement):
    """Each rung's Hastings factor against the JAX package's log-density
    of its group, proposal, complement and factor."""
    mv = moves.KDEMove(max_complement=max_complement)
    x = start(2).coords
    ng = NW // 2
    sub = None
    if max_complement is not None:
        gen = torch.Generator().manual_seed(split)
        sub = torch.stack([torch.randperm(NW - ng, generator=gen)[:9]
                           for _ in range(T)])
    q, f = mv.get_proposal((rung_keys(5, T, "cpu"), 3), x, split,
                           port_model(), extra=None if sub is None
                           else {"sub": sub})
    for r in range(T):
        s = x[r, split * ng:(split + 1) * ng]
        c = complement(x[r], split, ng)
        if sub is not None:
            c = c[sub[r]]
        chol = cholesky_or_nan(mv._factor(c.shape[0], ND) ** 2 * cov(c))
        want = (jmoves.KDEMove._logpdf(jnp.asarray(s.numpy()),
                                       jnp.asarray(c.numpy()),
                                       jnp.asarray(chol.numpy()))
                - jmoves.KDEMove._logpdf(jnp.asarray(q[r].numpy()),
                                         jnp.asarray(c.numpy()),
                                         jnp.asarray(chol.numpy())))
        np.testing.assert_allclose(f[r].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("randomize_split", [True, False])
def test_propose_rungs_equals_each_rung_alone(randomize_split):
    """``propose_rungs`` under the rungs' keys against ``propose`` of each
    rung under its own key, the draws from the stream: the acceptance and
    counts exactly, the state within ``TOL``."""
    mv = moves.KDEMove(randomize_split=randomize_split)
    keys = rung_keys(21, T, "cpu")
    st = start(5)
    rungs = [State(st.coords[r].clone(), st.log_prob[r].clone(),
                   blobs=tuple(b[r].clone() for b in st.blobs))
             for r in range(T)]
    count = torch.zeros((T, NW), dtype=torch.int32)
    st, acc, _ = mv.propose_rungs((keys, 4), st, port_model(), (), count)
    for r in range(T):
        cr = torch.zeros(NW, dtype=torch.int32)
        sr, ar, _ = mv.propose((keys.seeds[r], 4), rungs[r],
                               port_model(BETAS[r]), (), cr)
        assert torch.equal(ar, acc[r]) and torch.equal(cr, count[r])
        close(sr.coords, st.coords[r])
        close(sr.log_prob, st.log_prob[r])
    assert 0 < int(acc.sum()) < T * NW


def ll_blobs(x):  # tests/unit/test_pt_parity.py:218-220
    ll = -0.5 * torch.sum((x - 1.0) ** 2)
    return ll, 2.0 * ll, x


def lp_box(x):
    return torch.where(torch.all(torch.abs(x) < 4.0), 0.0, -torch.inf)


@pytest.mark.parametrize("make,kw", [
    (lambda: moves.KDEMove(), {}),
    (lambda: moves.KDEMove(bw_method="silverman", max_complement=10,
                           randomize_split=False), {}),
    (lambda: [(moves.KDEMove(), 0.5), (moves.StretchMove(), 0.5)],
     dict(mixture_block=2)),
])
def test_batched_path_equals_the_per_rung_loop(make, kw):
    """Every rung at once (K7 and K2 with the rung axis, the log-prob over
    ``T * ng`` rows) against the forced per-rung loop: acceptance, swaps
    and random state exactly; chain, logL, logP and the blobs ``(2 logL,
    x)`` within ``TOL`` (the batched products); the box prior rejects some
    proposals, so its ``-inf`` branch runs."""
    ends = []
    for batched in (True, False):
        s = PTSampler(3, 16, 2, ll_blobs, lp_box, moves=make(), seed=11,
                      device="cpu", **kw)
        s._batched = batched
        s.run_mcmc(np.random.default_rng(2).normal(size=(3, 16, 2)), 4,
                   thin_by=2)
        s.run_mcmc(None, 3)
        blobs = s.get_blobs()
        ends.append(((s.get_chain(), s.get_log_like(), s.get_log_prior(),
                      np.asarray(blobs[0]), np.asarray(blobs[1])),
                     (s.backend.accepted, s.swaps_accepted,
                      s.swaps_proposed, s.backend.random_state)))
    for x, y in zip(ends[0][1], ends[1][1]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for x, y in zip(ends[0][0], ends[1][0]):
        close(x, y)
    assert 0 < ends[0][1][0].sum() < 11 * 3 * 16


def test_rung_batched_flag():
    """``KDEMove`` (and the walk move, the blend and ``ChEESHMCMove``
    beside it) proposes every rung at once; a user's subclass without the
    flag is refused on the rung axis."""
    assert moves.KDEMove().rung_batched
    assert moves.KDEMove(max_complement=4).rung_batched
    assert moves.WalkMove().rung_batched
    assert moves.BlendedMove([moves.DEMove(), moves.SideMove()]).rung_batched
    assert moves.ChEESHMCMove(0.1).rung_batched

    class OneAtATime(moves.ChEESHMCMove):
        rung_batched = False

    assert not OneAtATime(0.1).rung_batched
    with pytest.raises(ValueError, match="one ensemble"):
        OneAtATime(0.1).propose_rungs(
            (rung_keys(0, T, "cpu"), 0), start(0), port_model(), ())


def test_cold_rung_moments_under_a_tempered_kde_move():
    """A tempered ``KDEMove()`` on every rung at once: the cold rung of a
    2-D unit Gaussian likelihood under a wide prior has mean ~0 and
    variance ~1 (the prior's pull, 1 / (1 + 1/100), is within the
    window)."""
    steps = 1000
    s = PTSampler(4, 32, 2, lambda x: -0.5 * torch.sum(x**2),
                  lambda x: -0.5 * torch.sum(x**2) / 100.0, seed=3,
                  device="cpu", moves=moves.KDEMove())
    assert s._batched
    s.run_mcmc(np.random.default_rng(7).normal(size=(4, 32, 2)), steps)
    assert s._program.batched
    cold = s.get_chain(temp=0, flat=True, discard=steps // 5)
    assert np.all(np.abs(cold.mean(axis=0)) < 0.1), cold.mean(axis=0)
    assert np.all(np.abs(cold.var(axis=0) - 1.0) < 0.15), cold.var(axis=0)
    assert np.all(s.acceptance_fraction > 0.2)
    assert np.all(s.tswap_acceptance_fraction > 0)
