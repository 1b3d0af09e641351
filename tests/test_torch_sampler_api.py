"""EnsembleSampler surface of the port: determinism, resume, guards,
vectorize, tuning, the generator and the arguments not ported yet."""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import emcee_tpu_torch
from emcee_tpu_torch import State, moves
from emcee_tpu_torch.backends import DeviceBackend

NW, ND = 16, 3


def lp_batch(x):
    return -0.5 * (x**2).sum(-1)


def p0(seed=0):
    return np.random.default_rng(seed).normal(size=(NW, ND))


def make(move=None, **kw):
    kw.setdefault("vectorize", True)
    return emcee_tpu_torch.EnsembleSampler(
        NW, ND, lp_batch, moves=move, device="cpu", seed=kw.pop("seed", 3),
        **kw,
    )


@pytest.mark.parametrize("roll", [True, False])
def test_same_seed_same_chain(roll):
    mv = (moves.StretchMove(randomize_split=False, pair_mode="roll")
          if roll else moves.StretchMove())
    a, b = make(mv), make(mv)
    a.run_mcmc(p0(), 50)
    b.run_mcmc(p0(), 50)
    np.testing.assert_array_equal(a.get_chain(), b.get_chain())
    c = make(mv, seed=4)
    c.run_mcmc(p0(), 50)
    assert not np.array_equal(a.get_chain(), c.get_chain())


@pytest.mark.parametrize("thin_by", [1, 3])
def test_resume_is_bit_identical(thin_by):
    mv = moves.StretchMove(randomize_split=False, pair_mode="roll")
    whole = make(mv)
    end = whole.run_mcmc(p0(), 40, thin_by=thin_by)
    split = make(mv)
    split.run_mcmc(p0(), 20, thin_by=thin_by)
    end2 = split.run_mcmc(None, 20, thin_by=thin_by)
    np.testing.assert_array_equal(whole.get_chain(), split.get_chain())
    np.testing.assert_array_equal(whole.get_log_prob(), split.get_log_prob())
    np.testing.assert_array_equal(whole.backend.accepted,
                                  split.backend.accepted)
    assert torch.equal(end.coords, end2.coords)
    assert end.random_state == end2.random_state == (3, 40 * thin_by)
    # A new sampler over the stored backend resumes from its last sample.
    third = emcee_tpu_torch.EnsembleSampler(
        NW, ND, lp_batch, vectorize=True, device="cpu",
        backend=split.backend,
        moves=moves.StretchMove(randomize_split=False, pair_mode="roll"),
    )
    assert third.random_state == end.random_state
    third.run_mcmc(None, 5)
    whole.run_mcmc(None, 5)
    np.testing.assert_array_equal(whole.get_chain()[-5:],
                                  third.get_chain()[-5:])


def test_chunked_run_equals_one_chunk():
    mv = moves.StretchMove(randomize_split=False, pair_mode="roll")
    a, b = make(mv), make(mv, max_chunk_steps=7)
    a.run_mcmc(p0(), 30)
    b.run_mcmc(p0(), 30)
    np.testing.assert_array_equal(a.get_chain(), b.get_chain())


def test_store_false_and_run_stats():
    s = make()
    st = s.run_mcmc(p0(), 30, store=False)
    assert s.iteration == 0
    stats = s.last_run_stats
    assert stats.nproposals == 30 and stats.nwalkers == NW
    acc = stats.acceptance_fraction
    assert acc.shape == (NW,) and 0.1 < acc.mean() < 0.9
    assert st.random_state == (3, 30)
    assert st.coords.shape == (NW, ND)


def test_caller_state_is_not_written():
    s = make()
    coords = torch.from_numpy(p0()).float()
    keep = coords.clone()
    s.run_mcmc(State(coords), 10)
    assert torch.equal(coords, keep)


def test_compute_log_prob_guards():
    s = make()
    x = p0()
    lp, blobs = s.compute_log_prob(x)
    assert blobs is None
    np.testing.assert_allclose(lp.numpy(), -0.5 * (x**2).sum(-1), rtol=1e-6)
    bad = x.copy()
    bad[0, 0] = np.inf
    with pytest.raises(ValueError, match="infinite"):
        s.compute_log_prob(bad)
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        s.compute_log_prob(bad)
    nan_lp = emcee_tpu_torch.EnsembleSampler(
        NW, ND, lambda x: torch.full((x.shape[0],), torch.nan),
        vectorize=True, device="cpu",
    )
    with pytest.raises(ValueError, match="Probability function returned NaN"):
        nan_lp.compute_log_prob(x)


def test_prepare_state_guards():
    s = make()
    with pytest.raises(ValueError, match="incompatible input dimensions"):
        s.run_mcmc(np.zeros((NW, ND + 1)), 1)
    with pytest.raises(ValueError, match="condition number"):
        s.run_mcmc(np.ones((NW, ND)), 1)
    s.run_mcmc(np.ones((NW, ND)) + 1e-3 * p0(), 1,
               skip_initial_state_check=True)
    with pytest.raises(ValueError, match="initial log_prob was NaN"):
        s.run_mcmc(State(p0(), np.full(NW, np.nan)), 1)


def test_nsteps_zero_returns_none_and_clears_anchor():
    s = make()
    s.run_mcmc(p0(), 5)
    assert s.run_mcmc(None, 0) is None
    with pytest.raises(ValueError, match="initial_state=None"):
        s.run_mcmc(None, 5)


def test_vectorize_false_lifts_with_vmap_and_args():
    def lp_one(x, mu, scale=1.0):
        return -0.5 * torch.sum(((x - mu) / scale) ** 2)

    mu = torch.tensor([1.0, -1.0, 0.5])
    s = emcee_tpu_torch.EnsembleSampler(
        NW, ND, lp_one, args=(mu,), kwargs={"scale": 2.0}, device="cpu",
    )
    x = p0()
    lp, _ = s.compute_log_prob(x)
    ref = -0.5 * (((x - mu.numpy()) / 2.0) ** 2).sum(-1)
    np.testing.assert_allclose(lp.numpy(), ref, rtol=1e-5)
    s.run_mcmc(x, 5)
    assert s.get_chain().shape == (5, NW, ND)


def test_blobs_raise_not_implemented():
    """Tensor blobs run (tests/test_torch_blobs.py); a blob that is not
    numeric needs host evaluation, which is ROADMAP P12."""
    s = emcee_tpu_torch.EnsembleSampler(
        NW, ND, lambda x: (-0.5 * (x**2).sum(-1), "a string"),
        vectorize=True, device="cpu",
    )
    with pytest.raises(NotImplementedError, match="P12"):
        s.run_mcmc(p0(), 1)


def test_tune_moves_log_adj():
    mv = moves.StretchMove(tune_target=0.25)
    s = make(mv)
    s.run_mcmc(p0(), 30, tune=True)
    carry = s._move_carries[0]
    assert int(carry["t"]) == 30
    assert float(carry["log_adj"]) != 0.0
    s.run_mcmc(None, 10)  # tune=False leaves the carry alone
    assert int(s._move_carries[0]["t"]) == 30
    with pytest.raises(ValueError, match="tune_target"):
        moves.RedBlueMove(tune_target=0.3)


def test_sample_generator_and_thin():
    s = make()
    states = list(s.sample(p0(), iterations=4, thin_by=2))
    assert len(states) == 4
    assert [st.random_state[1] for st in states] == [2, 4, 6, 8]
    assert s.iteration == 4
    # Each yielded state is a snapshot, not a view of the live ensemble.
    assert not torch.equal(states[0].coords, states[-1].coords)
    with pytest.warns(DeprecationWarning):
        s.run_mcmc(None, 6, thin=3)
    assert s.iteration == 6
    with pytest.raises(ValueError, match="store"):
        next(s.sample(p0(), iterations=None))


#: arguments of this list that are ported now (ROADMAP P7, P10; ``prng``
#: since F3's repair): the sampler takes them, holding each in this
#: attribute as this value
PORTED = {
    "prng": ("prng", "rbg"),
    "mixture_block": ("_mixture_block", 4),
    "blobs_dtype": ("blobs_dtype", float),
    "parameter_names": ("parameter_names", {"a": 0, "b": 1, "c": 2}),
    "io_dtype": ("_io_dtype", torch.float16),
}


@pytest.mark.parametrize("name,value", [
    ("pool", object()), ("mesh", object()), ("param_axis", "p"),
    ("host_callback", True), ("blobs_dtype", float),
    ("parameter_names", ["a", "b", "c"]), ("io_dtype", np.float16),
    ("mixture_block", 4), ("prng", "rbg"),
])
def test_not_ported_arguments_raise(name, value):
    if name in PORTED:
        s = emcee_tpu_torch.EnsembleSampler(NW, ND, lp_batch, device="cpu",
                                            **{name: value})
        attr, held = PORTED[name]
        assert getattr(s, attr) == held
        return
    with pytest.raises(NotImplementedError, match="ROADMAP P"):
        emcee_tpu_torch.EnsembleSampler(NW, ND, lp_batch, device="cpu",
                                        **{name: value})


@pytest.mark.parametrize("prng", [None, "threefry2x32", "rbg", "unsafe_rbg",
                                  "philox"])
def test_prng_takes_what_jax_random_key_takes(prng):
    """``prng`` takes the key implementations ``jax.random.key`` takes and
    samples from the same Philox stream for each; another value raises
    ``ValueError`` as ``jax.random.key`` does."""
    if prng == "philox":
        with pytest.raises(ValueError, match="PRNG implementation"):
            emcee_tpu_torch.EnsembleSampler(NW, ND, lp_batch, device="cpu",
                                            vectorize=True, prng=prng)
        with pytest.raises(ValueError):
            jax.random.key(0, impl=prng)
        return
    jax.random.key(0, impl=prng)
    chains = []
    for p in (prng, None):
        s = emcee_tpu_torch.EnsembleSampler(NW, ND, lp_batch, device="cpu",
                                            vectorize=True, seed=3, prng=p)
        s.run_mcmc(np.random.default_rng(0).normal(size=(NW, ND)), 4)
        chains.append(s.get_chain())
    np.testing.assert_array_equal(*chains)


def test_device_backend_run_matches_host_backend():
    mv = moves.StretchMove(randomize_split=False, pair_mode="roll")
    host = make(mv)
    dev = make(mv, backend=DeviceBackend(), max_chunk_steps=4)
    host.run_mcmc(p0(), 10, thin_by=2)
    dev.run_mcmc(p0(), 10, thin_by=2)
    np.testing.assert_array_equal(
        host.get_chain(), dev.get_chain().astype(np.float64))
    np.testing.assert_array_equal(host.acceptance_fraction,
                                  dev.acceptance_fraction)
