"""``DEZMove`` on every rung of the port's tempered ladder: K10a, K10b and
K10c with the rung axis (``emcee_tpu_torch/ops/dez_kernel.py``) under
``DEZMove`` (``moves/de_z.py``, ``rung_batched``), the counterpart of the
JAX package's ``jax.vmap`` of the move over the rungs with one archive a
rung (``emcee_tpu/parallel/tempering.py:439-541``).

Each kernel computes every rung exactly as that rung alone, so on a 4-rung
x 32-walker ladder the batched ``PTSampler`` equals the forced per-rung
loop (the private ``_batched`` switch) bit for bit: chain, logL, logP,
acceptance, swaps and every rung's archive and words, shuffled and
blocked, on each branch of the move.  Then one statistical oracle: the
cold rung of the bimodal target against the JAX ``PTSampler`` with
``DEZMove`` from the same start (the mode fraction, ``|x|``'s mean and
spread of each within Monte Carlo windows of the other's).  JAX runs on
the CPU (tests/conftest.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu import moves as jmoves
from emcee_tpu.parallel.tempering import PTSampler as JPTSampler

from emcee_tpu_torch import PTSampler, moves

T, NW, ND = 4, 32, 2


def ll_bimodal(x):  # tests/unit/test_tempering.py:23-26
    a = -0.5 * torch.sum((x - 5.0) ** 2)
    b = -0.5 * torch.sum((x + 5.0) ** 2)
    return torch.logaddexp(a, b)


def lp_box(x):  # tests/unit/test_tempering.py:29-30
    return torch.where(torch.all(torch.abs(x) < 20.0), 0.0, -torch.inf)


def j_ll_bimodal(x):
    a = -0.5 * jnp.sum((x - 5.0) ** 2)
    b = -0.5 * jnp.sum((x + 5.0) ** 2)
    return jnp.logaddexp(a, b)


def j_lp_box(x):
    return jnp.where(jnp.all(jnp.abs(x) < 20.0), 0.0, -jnp.inf)


@pytest.mark.parametrize("make", [
    lambda: moves.DEZMove(archive_size=96, update_rows=16),
    lambda: moves.DEZMove(snooker_prob=0.5, g1_prob=0.3, de_noise=0.1,
                          archive_size=64, update_rows=24,
                          randomize_split=False),
    lambda: moves.DEZMove(de_noise=0.0, snooker_prob=0.0, g1_prob=0.0,
                          nsplits=4, archive_size=40, update_rows=8),
])
def test_batched_path_equals_the_per_rung_loop(make):
    ends = []
    for batched in (True, False):
        mv = make()
        s = PTSampler(T, NW, ND, ll_bimodal, lp_box, moves=mv, seed=7,
                      device="cpu")
        s._batched = batched
        start = np.random.default_rng(3).normal(size=(T, NW, ND)) * 3.0
        s.run_mcmc(start, 8, thin_by=2)
        s.run_mcmc(None, 5)
        assert s._program.batched is batched
        carry = {k: v.clone() for k, v in s._move_carries[0].items()}
        ends.append((s.get_chain(), s.get_log_like(), s.get_log_prior(),
                     s.backend.accepted, s.swaps_accepted, s.swaps_proposed,
                     carry))
    for x, y in zip(ends[0][:6], ends[1][:6]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    a, b = ends[0][6], ends[1][6]
    assert a.keys() == b.keys() == {"z", "filled", "ptr", "t"}
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert a["z"].shape[0] == T and torch.all(a["t"] == 21)
    assert torch.all(a["filled"] > 0)
    assert 0 < ends[0][3].sum() < T * NW * 21


def test_cold_rung_matches_the_jax_sampler():
    """Both samplers from one start on the bimodal target (modes at +-5):
    the cold rung's mode fraction, mean ``|x|`` and its spread agree with
    the JAX ``PTSampler``'s within Monte Carlo windows, and each holds
    both modes."""
    nsteps, discard = 1500, 500
    start = np.random.default_rng(1).uniform(-8, 8, size=(T, NW, 1))
    port = PTSampler(T, NW, 1, ll_bimodal, lp_box, seed=0, device="cpu",
                     moves=moves.DEZMove())
    port.run_mcmc(start, nsteps)
    jpt = JPTSampler(T, NW, 1, j_ll_bimodal, j_lp_box, seed=0,
                     moves=jmoves.DEZMove())
    jpt.run_mcmc(start.astype(np.float32), nsteps)
    stats = []
    for s in (port, jpt):
        x = np.asarray(s.get_chain(temp=0, discard=discard, flat=True))
        assert np.all(np.isfinite(x))
        stats.append(((x > 0).mean(), np.abs(x).mean(), np.abs(x).std()))
    (fp, mp, sp), (fj, mj, sj) = stats
    for frac in (fp, fj):
        assert 0.25 < frac < 0.75, stats
    assert abs(fp - fj) < 0.25, stats
    assert abs(mp - 5.0) < 0.2 and abs(mj - 5.0) < 0.2, stats
    assert abs(mp - mj) < 0.15, stats
    assert abs(sp - sj) < 0.15 and abs(sp - 1.0) < 0.15, stats
    assert np.all(port.tswap_acceptance_fraction > 0.2)
