"""``parameter_names`` and ``io_dtype`` in the port.

``parameter_names`` mirrors ``tests/unit/test_sampler.py:269-299`` (the
log-prob of stored steps is the named function of the stored coords, to
float32 rounding: rtol 1e-5), adds the JAX sampler's assertions, and
holds a named run bit for bit against the unnamed run of the same
function.  ``io_dtype`` mirrors the three ``test_io_dtype_*`` tests
(``tests/unit/test_sampler.py:372``, ``:420``, ``:459``); where the JAX
test allows float16 resolution (both packages draw the same chain, only
the stored copy rounds), the port holds the stored float16 chain equal
to the float32 chain cast, exactly.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import emcee_tpu_torch
from emcee_tpu_torch import EnsembleSampler
from emcee_tpu_torch.backends import Backend, DeviceBackend

NW, ND = 16, 3


def p0(seed=0, nw=NW, nd=ND):
    return np.random.default_rng(seed).normal(size=(nw, nd))


def test_named_parameters():
    def lp(params):
        return -0.5 * (params["x"] ** 2 + (params["y"] ** 2).sum())

    s = EnsembleSampler(NW, ND, lp, parameter_names={"x": 0, "y": [1, 2]},
                        seed=0, device="cpu")
    s.run_mcmc(p0(), 10)
    assert s.get_chain().shape == (10, NW, ND)
    expected = -0.5 * np.sum(s.get_chain() ** 2, axis=-1)
    np.testing.assert_allclose(s.get_log_prob(), expected, rtol=1e-5)
    assert s.params_are_named and s.parameter_names == {"x": 0, "y": [1, 2]}


def test_named_parameters_list():
    def lp(params):
        return -0.5 * (params["a"] ** 2 + params["b"] ** 2)

    s = EnsembleSampler(16, 2, lp, parameter_names=["a", "b"], seed=0,
                        device="cpu")
    s.run_mcmc(p0(nd=2), 10)
    assert s.get_chain().shape == (10, 16, 2)
    assert s.parameter_names == {"a": 0, "b": 1}


def test_named_run_is_bit_identical_to_the_unnamed_one():
    """The adapter only renames: the same function of the same walkers
    gives the same chain, log-prob, blobs and acceptance, bit for bit."""
    def named(p):
        r2 = p["a"] ** 2 + (p["rest"] ** 2).sum()
        return -0.5 * r2, p["rest"] * p["a"]

    def plain(x):
        r2 = x[0] ** 2 + (x[torch.tensor([1, 2])] ** 2).sum()
        return -0.5 * r2, x[torch.tensor([1, 2])] * x[0]

    runs = []
    for fn, names in ((named, {"a": 0, "rest": [1, 2]}), (plain, None)):
        s = EnsembleSampler(NW, ND, fn, parameter_names=names, seed=4,
                            device="cpu")
        s.run_mcmc(p0(1), 12)
        runs.append(s)
    a, b = runs
    for get in ("get_chain", "get_log_prob", "get_blobs"):
        np.testing.assert_array_equal(getattr(a, get)(), getattr(b, get)())
    np.testing.assert_array_equal(a.backend.accepted, b.backend.accepted)


@pytest.mark.parametrize("names,kw,msg", [
    (["a", "b", "c"], dict(vectorize=True), "vectorization unsupported"),
    (["a", "a", "c"], {}, "duplicate parameters"),
    (["a", "b"], {}, "name all parameters"),
    ({"a": 0, "b": 1}, {}, "not all values appear"),
    ({"a": 0, "b": 1, "c": 2, "d": [0]}, {}, "too many names"),
    ("abc", {}, ""),
])
def test_named_parameter_checks(names, kw, msg):
    """The JAX sampler's assertions (``emcee_tpu/sampler.py:321-357``),
    raised as ``AssertionError`` as there."""
    with pytest.raises(AssertionError, match=msg):
        EnsembleSampler(NW, ND, lambda p: 0.0, parameter_names=names,
                        device="cpu", **kw)


def lp_with_blobs(x):
    lp = -0.5 * (x**2).sum()
    return lp, (2.0 * lp, torch.tensor(1, dtype=torch.int32))


def test_io_dtype_casts_stored_chain():
    """``io_dtype`` compresses only the stored copies: the chain and the
    float blob leaf are float16, the int leaf stays int32, the live state
    and the log-prob stay float32, and the stored chain is the float32
    chain of the same seed cast to float16, exactly."""
    nw = 32
    coords = p0(3, nw=nw)

    def run(io_dtype):
        s = EnsembleSampler(nw, ND, lp_with_blobs, seed=7, device="cpu",
                            backend=Backend(
                                dtype=np.float16 if io_dtype else None),
                            io_dtype=io_dtype)
        return s, s.run_mcmc(coords, 40)

    s16, state16 = run(np.float16)
    s32, state32 = run(None)
    assert s16.backend.chain.dtype == np.float16
    blob16 = s16.get_blobs()
    assert blob16[0].dtype == np.float16
    assert blob16[1].dtype == np.int32
    assert state16.coords.dtype == state32.coords.dtype == torch.float32
    assert state16.log_prob.dtype == state32.log_prob.dtype
    assert torch.equal(state16.coords, state32.coords)
    np.testing.assert_array_equal(
        s16.get_chain(), s32.get_chain().astype(np.float32)
        .astype(np.float16))
    np.testing.assert_array_equal(
        blob16[0], s32.get_blobs()[0].astype(np.float16))
    # The log-prob is not cast by io_dtype; the float16 backend stores
    # it in its own dtype, as the JAX package's does.
    np.testing.assert_array_equal(
        s16.get_log_prob(), s32.get_log_prob().astype(np.float16))


def test_io_dtype_into_device_backend_and_default_backend():
    """Into a ``DeviceBackend`` the stored chain is float16 itself; into a
    default (float64) ``Backend`` it holds the float16 values."""
    out = {}
    for name, backend, io in (("device", DeviceBackend(), np.float16),
                              ("host", Backend(), np.float16),
                              ("ref", Backend(), None)):
        s = EnsembleSampler(NW, ND, lambda x: (-0.5 * (x**2).sum(-1),
                                               x.mean(-1)),
                            vectorize=True, seed=2, device="cpu",
                            backend=backend, io_dtype=io)
        s.run_mcmc(p0(4), 6, thin_by=2)
        out[name] = (s.get_chain(), s.get_blobs(), s.get_log_prob())
    assert out["device"][0].dtype == np.float16
    assert out["device"][1].dtype == np.float16
    assert out["device"][2].dtype == np.float32
    assert out["host"][0].dtype == np.float64
    want = out["ref"][0].astype(np.float32).astype(np.float16)
    np.testing.assert_array_equal(out["device"][0], want)
    np.testing.assert_array_equal(out["host"][0], want.astype(np.float64))
    np.testing.assert_array_equal(out["host"][1], out["device"][1])


@pytest.mark.parametrize("bad", [np.int32, "S3", torch.bfloat16])
def test_io_dtype_rejects_non_float(bad):
    with pytest.raises(ValueError, match="floating"):
        EnsembleSampler(8, 2, lambda x: -0.5 * (x**2).sum(), io_dtype=bad,
                        device="cpu")


def test_io_dtype_resume_upcasts():
    """Resuming from a float16 store samples in float32 and recomputes
    the log-prob from the rounded restart coords."""
    backend = Backend(dtype=np.float16)
    s = EnsembleSampler(NW, 2, lambda x: -0.5 * (x**2).sum(), seed=5,
                        backend=backend, io_dtype=np.float16, device="cpu")
    s.run_mcmc(p0(8, nd=2), 10)
    s2 = EnsembleSampler(NW, 2, lambda x: -0.5 * (x**2).sum(), seed=5,
                         backend=backend, io_dtype=np.float16, device="cpu")
    last = s2._previous_state
    assert np.asarray(last.coords).dtype == np.float16
    state = s2.run_mcmc(None, 5)
    assert state.coords.dtype == torch.float32
    assert torch.isfinite(state.log_prob).all()
    assert s2.backend.iteration == 15
    # The recomputed log-prob belongs to the rounded coords.
    first = s2.get_log_prob()[10]
    assert np.isfinite(first).all()


def test_io_dtype_pickles_and_public_names():
    import pickle

    s = EnsembleSampler(NW, ND, lp_with_blobs, seed=1, device="cpu",
                        io_dtype=np.float16, parameter_names=None)
    s.run_mcmc(p0(), 3)
    clone = pickle.loads(pickle.dumps(s))
    clone.run_mcmc(None, 2)
    s.run_mcmc(None, 2)
    np.testing.assert_array_equal(clone.get_chain(), s.get_chain())
    assert "checkpoint" in emcee_tpu_torch.__all__
