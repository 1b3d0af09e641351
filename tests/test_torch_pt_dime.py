"""``DIMEMove`` on every rung of the port's tempered ladder: K8a, K8b and
K8c with the rung axis (``emcee_tpu_torch/ops/dime_kernel.py``) under
``DIMEMove`` (``moves/dime.py``, ``rung_batched``), the counterpart of the
JAX package's ``jax.vmap`` of the move over the rungs
(``emcee_tpu/parallel/tempering.py:449-541``).

Each kernel computes every rung exactly as that rung alone, so the
batched ``PTSampler`` equals the forced per-rung loop (the private
``_batched`` switch) bit for bit: chain, logL, logP, the carries,
acceptance and swaps, for one component and for two, blocked and
shuffled.  Then ``tests/unit/test_tempering.py:299-318``
(``test_pt_dime_adapts_per_rung``): every rung's carry accumulates history
and the hot rung's proposal spread exceeds the cold one's.  JAX runs on
the CPU (tests/conftest.py); the oracle needs none of it.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu_torch import PTSampler, moves

T, NW, ND = 4, 32, 2


def ll_bimodal(x):  # tests/unit/test_tempering.py:23-26
    a = -0.5 * torch.sum((x - 5.0) ** 2)
    b = -0.5 * torch.sum((x + 5.0) ** 2)
    return torch.logaddexp(a, b)


def lp_box(x):  # tests/unit/test_tempering.py:29-30
    return torch.where(torch.all(torch.abs(x) < 20.0), 0.0, -torch.inf)


@pytest.mark.parametrize("make", [
    lambda: moves.DIMEMove(aimh_prob=0.3),
    lambda: moves.DIMEMove(aimh_prob=0.3, n_components=2, df=7.5,
                           randomize_split=False),
    lambda: moves.DIMEMove(aimh_prob=1.0, n_components=2, df=None),
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
        carry = {k: v.clone() for k, v in s._move_carries[0].items()}
        ends.append((s.get_chain(), s.get_log_like(), s.get_log_prior(),
                     s.backend.accepted, s.swaps_accepted, s.swaps_proposed,
                     carry, int(mv._exhausted("cpu"))))
    for x, y in zip(ends[0][:6], ends[1][:6]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    a, b = ends[0][6], ends[1][6]
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert 0 < ends[0][3].sum() < T * NW * 21
    assert float(a["w"].min()) > 0
    assert ends[0][7] == ends[1][7] == 0


def test_pt_dime_adapts_per_rung():
    """``tests/unit/test_tempering.py:299-318``: the adaptive moments are
    carried per rung, every rung accumulates history, and the hot rung's
    proposal spread exceeds the cold rung's."""
    pt = PTSampler(T, NW, ND, ll_bimodal, lp_box,
                   moves=moves.DIMEMove(aimh_prob=0.15), seed=5,
                   device="cpu")
    pt.run_mcmc(np.random.default_rng(2).normal(size=(T, NW, ND)), 300)
    assert np.all(np.isfinite(pt.get_chain()))
    carry = {k: v.numpy() for k, v in pt._move_carries[0].items()}
    assert carry["mean"].shape == (T, ND)
    assert carry["cov"].shape == (T, ND, ND)
    assert np.all(carry["w"] > 0)
    assert np.trace(carry["cov"][-1]) > np.trace(carry["cov"][0])
