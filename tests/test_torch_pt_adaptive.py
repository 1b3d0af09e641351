"""The adaptive ladder of the port's PTSampler against the JAX package's.

Exact: ``PTSampler._adapt_ladder`` (numpy on the host) against the JAX
sampler's on the same ``(swap counts, previous counts, chunk proposals,
proposals done)``, for 2-16 rungs and several calls in a row (tolerance
0: the same float64 operations in the same order); and the chunk
schedule of an adaptive run (the ladder adapts at chunk boundaries, so
the schedule is part of the result) against the JAX package's
``chunk_schedule(nsteps, _max_chunk(blobs), mixture_block)`` for several
shapes, ``io_chunk_bytes``, ``io_dtype``, blobs and mixtures.  Then the
twins of ``tests/unit/test_tempering.py:194`` (the ladder equalizes the
swap rates; ``slow``), ``:227`` (the adapted ladder is resumed) and
``:403`` (an interrupt leaves ``self.betas`` at the stored ladder).  JAX
runs on the CPU (tests/conftest.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu.driver import chunk_schedule as j_chunk_schedule
from emcee_tpu.parallel.tempering import PTSampler as JPTSampler

from emcee_tpu_torch import PTSampler, moves
from emcee_tpu_torch.backends import PTBackend, PTDeviceBackend
from emcee_tpu_torch.parallel import default_beta_ladder


def ll_bimodal(x):  # tests/unit/test_tempering.py:23-26
    a = -0.5 * torch.sum((x - 5.0) ** 2)
    b = -0.5 * torch.sum((x + 5.0) ** 2)
    return torch.logaddexp(a, b)


def lp_box(x):
    return torch.where(torch.all(torch.abs(x) < 20.0), 0.0, -torch.inf)


def ll_blobs(x):
    ll = -0.5 * torch.sum(x**2)
    return ll, 2.0 * ll, x


@pytest.mark.parametrize("T", [2, 3, 6, 16])
def test_adapt_ladder_matches_jax(T):
    nw = 32
    rng = np.random.default_rng(T)
    for swap_every, betas in ((1, default_beta_ladder(T, 2)),
                              (3, default_beta_ladder(T, 1, max_temp=1e5))):
        kw = dict(betas=betas.copy(), swap_every=swap_every,
                  adaptation_lag=300, adaptation_time=7)
        port = PTSampler(T, nw, 2, ll_bimodal, lp_box, device="cpu", **kw)
        jpt = JPTSampler(T, nw, 2, lambda x: -0.5 * jnp.sum(x**2),
                         lambda x: 0.0, **kw)
        prev_p = prev_j = np.zeros(max(T - 1, 1), dtype=np.int64)
        acc = np.zeros((T, nw), dtype=np.int64)
        done = 0
        for props in (100, 37, 250):
            done += props
            acc += rng.integers(0, props // swap_every + 1, size=(T, nw)) // 2
            got, prev_p = port._adapt_ladder(acc.sum(axis=1)[: T - 1],
                                             prev_p, props, done)
            want, prev_j = jpt._adapt_ladder(acc, prev_j, props, done)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(prev_p, np.asarray(prev_j))
            port.betas = jpt.betas = np.asarray(want)
            if T >= 3:
                assert got[0] == 1.0 and not np.array_equal(got, betas)


def recorded_sizes(s, *args, **kw):
    """The kept steps of each chunk of ``s.run_mcmc(*args, **kw)``."""
    sizes = []
    enqueue = s._enqueue

    def spy(prog, offset, nkeep, *rest):
        sizes.append(nkeep)
        return enqueue(prog, offset, nkeep, *rest)

    s._enqueue = spy
    s.run_mcmc(*args, **kw)
    del s._enqueue
    return sizes


@pytest.mark.parametrize("case", [
    dict(T=3, nw=8, nd=2, io=1 << 12, nsteps=37, thin_by=1),
    dict(T=4, nw=16, nd=3, io=40_000, nsteps=100, thin_by=2),
    dict(T=2, nw=8, nd=2, io=1 << 27, nsteps=9000, thin_by=1,
         store=False),
    dict(T=3, nw=8, nd=2, io=6_000, nsteps=29, thin_by=3, blobs=True),
    dict(T=3, nw=8, nd=2, io=6_000, nsteps=40, thin_by=1, io_dtype=np.float16,
         blobs=True),
    dict(T=3, nw=8, nd=2, io=3_000, nsteps=42, thin_by=1, mix=4),
])
def test_adaptive_chunk_schedule_matches_jax(case):
    """An adaptive run cuts its chunks where the JAX package cuts them
    (``emcee_tpu/parallel/tempering.py:1355-1360`` with ``_max_chunk`` of
    the state's blobs)."""
    T, nw, nd = case["T"], case["nw"], case["nd"]
    kw = dict(adaptive=True, io_chunk_bytes=case["io"],
              io_dtype=case.get("io_dtype"))
    if "mix" in case:
        kw.update(moves=[(moves.StretchMove(), 0.5), (moves.DEMove(), 0.5)],
                  mixture_block=case["mix"])
    blobs = case.get("blobs", False)
    s = PTSampler(T, nw, nd, ll_blobs if blobs else ll_bimodal, lp_box,
                  device="cpu", **kw)
    jkw = {k: v for k, v in kw.items() if k != "moves"}
    jpt = JPTSampler(T, nw, nd, lambda x: 0.0, lambda x: 0.0, **jkw)
    jblobs = ((np.zeros((T, nw), np.float32),
               np.zeros((T, nw, nd), np.float32)) if blobs else None)
    want = j_chunk_schedule(case["nsteps"], jpt._max_chunk(jblobs),
                            case.get("mix", 1))
    p0 = np.random.default_rng(0).normal(size=(T, nw, nd))
    if case["nsteps"] > 1000:  # the schedule alone: a long run's sizes
        st = s._prepare_state(p0)
        got = j_chunk_schedule(case["nsteps"], s._max_chunk(
            st.blobs, case.get("store", True)), 1)
        assert s._max_chunk(st.blobs) == jpt._max_chunk(jblobs) == 4096
    else:
        got = recorded_sizes(s, p0, case["nsteps"],
                             thin_by=case["thin_by"],
                             store=case.get("store", True))
    assert got == want and len(want) > 1


@pytest.mark.slow
def test_adaptive_ladder_equalizes_swap_rates():
    """The twin of test_tempering.py:194: a bad geometric ladder (huge top
    temperature) moves toward equal adjacent swap acceptance (a long
    statistical run: the fast tier holds the ladder's arithmetic and
    schedule to JAX's exactly, and phase 15 of chip_smoke.py runs this
    schedule at workload 4's size)."""
    T, nw, nd = 6, 64, 1
    bad = default_beta_ladder(T, nd, max_temp=1e6)

    def run(adaptive):
        pt = PTSampler(T, nw, nd, ll_bimodal, lp_box, betas=bad.copy(),
                       adaptive=adaptive, adaptation_lag=1000,
                       adaptation_time=20, seed=3, device="cpu")
        coords = np.random.default_rng(5).uniform(-8, 8, size=(T, nw, nd))
        pt.run_mcmc(coords, 100, store=False)
        for _ in range(12):
            pt.run_mcmc(None, 100, store=False)
        pt.run_mcmc(None, 300)
        return pt, np.asarray(pt.tswap_acceptance_fraction, dtype=float)

    pt_a, rates_a = run(True)
    pt_f, rates_f = run(False)
    assert not np.allclose(pt_a.betas, bad), "ladder never adapted"
    assert rates_a.std() < rates_f.std(), (rates_a, rates_f)
    assert pt_a.betas[0] == 1.0
    # The backend stores the ladder the last chunk ran on.
    np.testing.assert_array_equal(pt_a.backend.betas, pt_a.betas)


@pytest.mark.parametrize("backend", [PTBackend, PTDeviceBackend])
def test_adapted_ladder_restored_on_resume(backend):
    """The twin of test_tempering.py:227."""
    T, nw, nd = 5, 32, 1
    be = backend()
    pt = PTSampler(T, nw, nd, ll_bimodal, lp_box, adaptive=True,
                   adaptation_lag=500, adaptation_time=10, backend=be,
                   seed=0, device="cpu")
    coords = np.random.default_rng(2).uniform(-8, 8, size=(T, nw, nd))
    for i in range(5):
        pt.run_mcmc(coords if i == 0 else None, 80)
    adapted = pt.betas.copy()
    assert not np.allclose(adapted, default_beta_ladder(T, nd))
    resumed = PTSampler(T, nw, nd, ll_bimodal, lp_box, adaptive=True,
                        backend=be, seed=0, device="cpu")
    np.testing.assert_array_equal(resumed.betas, adapted)
    resumed.run_mcmc(None, 10)
    assert resumed.iteration == 5 * 80 + 10


def test_pt_adaptive_interrupt_ladder_consistent():
    """The twin of test_tempering.py:403: an interrupt in the save leaves
    ``self.betas`` at the ladder the backend holds, and the run resumes."""
    T, nw = 6, 32
    bad = default_beta_ladder(T, 1, max_temp=1e5)
    pt = PTSampler(T, nw, 1, ll_bimodal, lp_box, betas=bad.copy(),
                   adaptive=True, adaptation_lag=500, adaptation_time=10,
                   seed=0, backend=PTBackend(), device="cpu",
                   io_chunk_bytes=T * nw * 4 * 4 * 10)
    coords = np.random.default_rng(1).uniform(-8, 8, size=(T, nw, 1))
    orig = pt.backend.save_chunk
    calls = {"n": 0}

    def boom(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise KeyboardInterrupt
        return orig(*a, **k)

    pt.backend.save_chunk = boom
    with pytest.raises(KeyboardInterrupt):
        pt.run_mcmc(coords, 60)
    pt.backend.save_chunk = orig
    np.testing.assert_array_equal(pt.betas, np.asarray(pt.backend.betas))
    assert not np.allclose(pt.betas, bad)
    saved = pt.backend.iteration
    assert 0 < saved < 60
    pt.run_mcmc(None, 60 - saved)
    assert pt.backend.iteration == 60
    assert np.all(np.isfinite(pt.get_chain()))
