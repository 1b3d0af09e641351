"""The port's run loop as a drop-in for the JAX sampler: an interrupted
stored run resumes to the uninterrupted chain bit for bit, a pickled
sampler resumes to the same chain, every JAX constructor argument is
taken or refused by name, the v2 properties, ``accurate_timing``,
``io_chunk_bytes``, the top-level names and the convergence monitor."""

import inspect
import pickle
import re
import signal
import threading
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import emcee_tpu
from emcee_tpu import monitor as jmonitor

import emcee_tpu_torch
from emcee_tpu_torch import EnsembleSampler, moves
from emcee_tpu_torch.backends import Backend, DeviceBackend
from emcee_tpu_torch.monitor import stored_chain
from emcee_tpu_torch.utils import defer_interrupts

NW, ND = 16, 3


def lp_batch(x):
    return -0.5 * (x**2).sum(-1)


def p0(seed=0):
    return np.random.default_rng(seed).normal(size=(NW, ND))


def sequential_tuned():
    return moves.GaussianMove(0.5, mode="sequential", tune_target=0.3)


def make(backend=None, **kw):
    kw.setdefault("moves", sequential_tuned())
    return EnsembleSampler(NW, ND, lp_batch, vectorize=True, device="cpu",
                           seed=7, backend=backend, **kw)


class InterruptingBackend(Backend):
    """A host backend whose ``save_chunk`` raises SIGINT at its ``at``-th
    call, before it writes."""

    def __init__(self, at):
        super().__init__()
        self.at = at
        self.calls = 0

    def save_chunk(self, *args, **kwargs):
        self.calls += 1
        if self.calls == self.at:
            signal.raise_signal(signal.SIGINT)
        super().save_chunk(*args, **kwargs)


class InterruptingDeviceBackend(DeviceBackend):
    """A device backend whose ``commit`` raises SIGINT at its ``at``-th
    call, before it counts the rows."""

    def __init__(self, at):
        super().__init__()
        self.at = at
        self.calls = 0

    def commit(self, *args, **kwargs):
        self.calls += 1
        if self.calls == self.at:
            signal.raise_signal(signal.SIGINT)
        super().commit(*args, **kwargs)


N_KEPT, CHUNK = 12, 2


@pytest.fixture(scope="module")
def uninterrupted():
    ref = make(max_chunk_steps=CHUNK)
    ref.run_mcmc(p0(), N_KEPT, tune=True, thin_by=2)
    return ref


@pytest.mark.parametrize("kind", ["host", "device"])
@pytest.mark.parametrize("at", range(1, N_KEPT // CHUNK + 1))
def test_interrupted_run_resumes_bit_for_bit(uninterrupted, kind, at):
    """A Ctrl-C at the ``at``-th save of a stored run with ``tune=True``
    and a ``sequential`` Gaussian: the save and the resume anchors
    (state, carries, offset) move together, so ``run_mcmc(None, rest)``
    gives the uninterrupted chain with no chunk stored twice."""
    assert threading.current_thread() is threading.main_thread()
    backend = (InterruptingBackend(at) if kind == "host"
               else InterruptingDeviceBackend(at))
    s = make(backend, max_chunk_steps=CHUNK)
    with pytest.raises(KeyboardInterrupt):
        s.run_mcmc(p0(), N_KEPT, tune=True, thin_by=2)
    assert backend.calls == at and s.iteration == at * CHUNK
    assert s.random_state == (7, 2 * s.iteration)
    rest = N_KEPT - s.iteration
    if rest:
        s.run_mcmc(None, rest, tune=True, thin_by=2)
    ref = uninterrupted
    assert s.iteration == ref.iteration == N_KEPT
    np.testing.assert_array_equal(s.get_chain().astype(np.float64),
                                  ref.get_chain())
    np.testing.assert_array_equal(s.get_log_prob().astype(np.float64),
                                  ref.get_log_prob())
    np.testing.assert_array_equal(s.backend.accepted, ref.backend.accepted)
    assert s.random_state == ref.random_state
    for k, v in ref._move_carries[0].items():
        assert torch.equal(s._move_carries[0][k], v), k


def test_defer_interrupts_holds_sigint_until_the_block_ends():
    seen = []
    with pytest.raises(KeyboardInterrupt):
        with defer_interrupts():
            signal.raise_signal(signal.SIGINT)
            seen.append("after the signal")
    assert seen == ["after the signal"]
    # A block that raises drops the held interrupt.
    with pytest.raises(ValueError):
        with defer_interrupts():
            signal.raise_signal(signal.SIGINT)
            raise ValueError("the body's own error")
    assert signal.getsignal(signal.SIGINT) is signal.default_int_handler


@pytest.mark.parametrize("backend", [Backend, DeviceBackend])
def test_pickled_sampler_resumes_to_the_same_chain(backend):
    s = make(backend(), moves=moves.StretchMove(randomize_split=False,
                                                pair_mode="roll",
                                                tune_target=0.3))
    s.run_mcmc(p0(1), 10, tune=True)
    clone = pickle.loads(pickle.dumps(s))
    assert clone._program is None and clone._compute_log_prob is not None
    s.run_mcmc(None, 10, tune=True)
    clone.run_mcmc(None, 10, tune=True)
    np.testing.assert_array_equal(clone.get_chain(), s.get_chain())
    np.testing.assert_array_equal(clone.backend.accepted, s.backend.accepted)
    assert clone.random_state == s.random_state


#: a value other than the default for every argument of the JAX
#: sampler's constructor
NON_DEFAULT = {
    "nwalkers": 20, "ndim": 2, "log_prob_fn": lp_batch, "pool": object(),
    "moves": moves.StretchMove(), "args": (), "kwargs": {},
    "backend": Backend(), "vectorize": False, "blobs_dtype": float,
    "parameter_names": ["a", "b", "c"], "seed": 5, "prng": "rbg",
    "mesh": object(), "walker_axis": "w", "param_axis": "p",
    "host_callback": True, "io_chunk_bytes": 1 << 20, "scan_unroll": 1,
    "mixture_block": 2, "io_dtype": np.float16, "host_callback_blobs": "auto",
    "max_chunk_steps": 3, "a": 2.0, "postargs": (1,), "threads": 2,
    "live_dangerously": True, "runtime_sortingfn": sorted,
}
JAX_ARGS = [n for n in inspect.signature(
    emcee_tpu.EnsembleSampler.__init__).parameters if n != "self"]


@pytest.mark.parametrize("name", JAX_ARGS)
def test_every_jax_constructor_argument_is_taken_or_named(name):
    """Drop-in code never meets a TypeError: each argument is accepted
    or refused with NotImplementedError naming its ROADMAP item."""
    kw = dict(nwalkers=NW, ndim=ND, log_prob_fn=lp_batch, vectorize=True,
              device="cpu")
    kw[name] = NON_DEFAULT[name]
    if name == "parameter_names":
        # Named parameters take one walker's dict, not a batch (the JAX
        # sampler asserts so).
        kw.update(vectorize=False, log_prob_fn=lambda p: -0.5 * (
            p["a"] ** 2 + p["b"] ** 2 + p["c"] ** 2))
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            s = EnsembleSampler(**kw)
    except NotImplementedError as err:
        assert re.search(r"ROADMAP P\d+", str(err)), str(err)
        return
    deprecated = name in ("a", "threads", "live_dangerously",
                          "runtime_sortingfn")
    assert deprecated == any(issubclass(w.category, DeprecationWarning)
                             for w in caught)
    s.run_mcmc(np.random.default_rng(0).normal(size=(s.nwalkers, s.ndim)),
               3)
    assert s.iteration == 3


def test_v2_properties_warn_and_match_the_getters():
    s = make()
    s.run_mcmc(p0(2), 6)
    pairs = (("chain", np.swapaxes(s.get_chain(), 0, 1)),
             ("flatchain", s.get_chain(flat=True)),
             ("lnprobability", np.swapaxes(s.get_log_prob(), 0, 1)),
             ("flatlnprobability", s.get_log_prob(flat=True)),
             ("blobs", None), ("flatblobs", None))
    for name, want in pairs:
        with pytest.warns(DeprecationWarning, match="deprecated"):
            got = getattr(s, name)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    s.run_mcmc(None, 200)
    want = s.get_autocorr_time(quiet=True)
    with pytest.warns(DeprecationWarning):
        try:
            got = s.acor
        except emcee_tpu_torch.AutocorrError as err:
            got = err.tau
    np.testing.assert_array_equal(got, want)


def test_accurate_timing_io_chunk_bytes_and_unused_arguments():
    a = make(moves=moves.StretchMove())
    a.run_mcmc(p0(3), 9, accurate_timing=True)
    assert a.last_run_stats.accurate and a.last_run_stats.walltime_s > 0
    row = NW * ((ND + 1) * 8 + 1)
    b = make(moves=moves.StretchMove(), io_chunk_bytes=2 * row,
             scan_unroll=1, walker_axis="shards")
    assert b._auto_chunk(True) == 2 and b.walker_axis == "shards"
    b.run_mcmc(p0(3), 9)
    np.testing.assert_array_equal(a.get_chain(), b.get_chain())
    with pytest.raises(ValueError, match="io_chunk_bytes"):
        make(io_chunk_bytes=0)


def test_backend_dtype_is_honoured():
    s = make(Backend(dtype=np.float32), moves=moves.StretchMove())
    s.run_mcmc(p0(4), 5)
    ref = make(moves=moves.StretchMove())
    ref.run_mcmc(p0(4), 5)
    assert s.get_chain().dtype == np.float32
    assert ref.get_chain().dtype == np.float64
    np.testing.assert_array_equal(s.get_chain(), ref.get_chain())


def test_top_level_names():
    for name in ("walkers_independent", "AutocorrError", "__version__",
                 "ConvergenceMonitor", "run_until_converged",
                 "EnsembleSampler", "State", "moves", "autocorr",
                 "backends", "utils"):
        assert name in emcee_tpu_torch.__all__
        assert hasattr(emcee_tpu_torch, name)
    assert emcee_tpu_torch.__version__ == emcee_tpu.__version__
    assert emcee_tpu_torch.walkers_independent(p0())
    assert not emcee_tpu_torch.walkers_independent(np.ones((NW, ND)))


def test_monitor_matches_jax_on_the_same_chain():
    rng = np.random.default_rng(6)
    chain = np.cumsum(rng.normal(size=(400, 8, 2)), axis=0) * 0.05
    chain += rng.normal(size=chain.shape)
    mine = emcee_tpu_torch.ConvergenceMonitor(rhat_threshold=1.01)
    ref = jmonitor.ConvergenceMonitor(rhat_threshold=1.01)
    for n in (200, 400):
        assert mine.update(chain[:n]) == ref.update(chain[:n])
        np.testing.assert_allclose(mine.tau, ref.tau, rtol=1e-4)
        np.testing.assert_allclose(mine.rhat, np.asarray(ref.rhat),
                                   rtol=1e-4)
    assert mine.iterations == ref.iterations == [200, 400]


def test_run_until_converged_reads_device_rows():
    """With a DeviceBackend the monitor reads the backend's tensor rows
    (no numpy copy of the chain) and stops where the host-backend run of
    the same seed stops, with the same estimates to float32 tolerance."""
    runs = {}
    for label, backend in (("host", Backend()), ("device", DeviceBackend())):
        s = make(backend, moves=moves.StretchMove(randomize_split=False,
                                                  pair_mode="roll"))
        _, mon = emcee_tpu_torch.run_until_converged(
            s, p0(5), max_steps=2400, check_every=300,
            monitor=emcee_tpu_torch.ConvergenceMonitor(
                tau_factor=10, dtau_rel=0.2, rhat_threshold=1.2))
        runs[label] = (s, mon)
    (hs, hm), (ds, dm) = runs["host"], runs["device"]
    assert isinstance(stored_chain(ds), torch.Tensor)
    assert isinstance(stored_chain(hs), np.ndarray)
    assert hs.iteration == ds.iteration and hm.iterations == dm.iterations
    np.testing.assert_allclose(dm.tau, hm.tau, rtol=1e-4)
    np.testing.assert_allclose(dm.rhat, hm.rhat, rtol=1e-4)
    assert hs.iteration < 2400  # converged before max_steps
