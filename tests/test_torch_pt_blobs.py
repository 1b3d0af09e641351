"""User blobs of the likelihood on the port's tempered ladder.

Exact: K15's plain version with user leaves against the JAX package's
``PTSampler._swap_step``, which exchanges every leaf of ``(coords, logL,
logP, blobs)`` together, under the same uniforms (drawn from the step's
key as ``_swap_step`` draws them, injected as ``u``; tolerance 0, the
exchanged values are copies); K2's plain version on the rung axis with
phase-C leaves against the one-ensemble plain K2 rung by rung; and a JAX
run's state with blobs continuing in the port.  Then the twins of
``tests/unit/test_pt_parity.py:222-304`` (blobs in the memory and device
backends, every stored row's blobs the function of its row; no blobs ->
None), ``tests/unit/test_tempering.py:472`` (a blob-less likelihood
cannot resume a chain with blobs) and ``tests/unit/test_pt_backends.py:
169-230`` (first blobs into a pre-grown store, ``_max_chunk`` counts
the blob bytes, inconsistent blob use refused by every backend).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu.parallel.tempering import PTSampler as JPTSampler

from emcee_tpu_torch import PTSampler
from emcee_tpu_torch.backends import PTBackend, PTDeviceBackend
from emcee_tpu_torch.convert import pt_state_from_numpy
from emcee_tpu_torch.ops.accept_kernel import accept_select_plain
from emcee_tpu_torch.ops.philox import rung_keys
from emcee_tpu_torch.ops.swap_kernel import pt_swap_plain, tempered_log_prob

NW, ND = 24, 3


def ll_blobs(x):  # tests/unit/test_pt_parity.py:218-220
    ll = -0.5 * torch.sum(x**2)
    return ll, 2.0 * ll, x


def lp_box(x):
    return torch.where(torch.all(torch.abs(x) < 20.0), 0.0, -torch.inf)


def j_ll_blobs(x):
    ll = -0.5 * jnp.sum(x**2)
    return ll, 2.0 * ll, x


def j_lp_box(x):
    return jnp.where(jnp.all(jnp.abs(x) < 20.0), 0.0, -jnp.inf)


def p0(T=3, nw=16, nd=2, seed=1):
    return np.random.default_rng(seed).normal(size=(T, nw, nd))


@pytest.mark.parametrize("T", [2, 3, 5])
@pytest.mark.parametrize("parity", [0, 1])
def test_plain_swap_with_leaves_matches_jax_swap_step(T, parity):
    rng = np.random.default_rng(T + 10 * parity)
    coords = rng.normal(size=(T, NW, ND)).astype(np.float32)
    ll = (3.0 * rng.normal(size=(T, NW))).astype(np.float32)
    ll[:, ::7] = np.nan
    lpr = np.zeros((T, NW), np.float32)
    lpr[:, 3::5] = -np.inf
    betas = (0.6 ** np.arange(T)).astype(np.float32)
    blobs = (rng.normal(size=(T, NW)).astype(np.float32),
             rng.integers(-9, 9, size=(T, NW, 3)).astype(np.int8),
             rng.normal(size=(T, NW, 2, 2)).astype(np.float32))
    jpt = JPTSampler(T, NW, ND, lambda x: -0.5 * jnp.sum(x**2),
                     lambda x: 0.0, betas=betas)
    key = jax.random.key(200 + T)
    (jc, jl, jp, jb), jacc, lo = jpt._swap_step(
        key, tuple(jnp.asarray(x) for x in (coords, ll, lpr))
        + (tuple(jnp.asarray(b) for b in blobs),),
        jnp.asarray(betas), parity)
    u = np.asarray(jax.random.uniform(key, (len(lo), NW)))
    c, l, p, b = (torch.tensor(x) for x in (coords, ll, lpr, betas))
    lp = tempered_log_prob(b[:, None], l, p)
    leaves = [torch.tensor(x) for x in blobs]
    counts = torch.zeros(T - 1, dtype=torch.int64)
    pt_swap_plain(c, l, p, lp, b, counts, offset=parity, u=torch.tensor(u),
                  leaves=leaves)
    for got, want in zip((c, l, p, *leaves), (jc, jl, jp, *jb)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = np.zeros(T - 1, np.int64)
    want[np.asarray(lo)] = np.asarray(jacc).sum(axis=1)
    np.testing.assert_array_equal(counts.numpy(), want)
    assert want.sum() > 0 or len(lo) == 0


@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("log_u", [False, True])
def test_k2_plain_rung_axis_with_leaves_equals_each_rung_alone(split, log_u):
    """Phase-C leaves (a float64 scalar, an int8 (3,) row, a float32 (5,)
    row) beside logL and logP: the rung axis's plain version selects each
    rung as the one-ensemble plain version does under the rung's key."""
    T, nw, nd, ns = 3, 12, 2, 2
    ng = nw // ns
    g = torch.Generator().manual_seed(split + 2 * log_u)
    coords = torch.randn(T, nw, nd, generator=g)
    q = torch.randn(T, ng, nd, generator=g)
    f = 0.3 * torch.randn(T, ng, generator=g)
    lp = -0.5 * (coords**2).sum(-1)
    lp_q = -0.5 * (q**2).sum(-1)
    lp_q[:, 1] = float("nan")
    shapes = [((), torch.float32), ((), torch.float32), ((), torch.float64),
              ((3,), torch.int8), ((5,), torch.float32)]
    news = [torch.randint(-50, 50, (T, ng) + s, generator=g).to(dt)
            for s, dt in shapes]
    bufs = [torch.randint(-50, 50, (T, nw) + s, generator=g).to(dt)
            for s, dt in shapes]
    keys = rung_keys(33, T, torch.device("cpu"))
    lu = torch.log(torch.rand(T, ng, generator=g)) if log_u else None
    c, l, b = coords.clone(), lp.clone(), [x.clone() for x in bufs]
    acc = torch.zeros(T, nw, dtype=torch.bool)
    cnt = torch.zeros(T, nw, dtype=torch.int32)
    accept_select_plain(q, f, lp_q, c, l, split, ns, acc, cnt, seed=keys,
                        offset=4, log_u=lu, blobs=list(zip(news, b)))
    for r in range(T):
        c1, l1 = coords[r].clone(), lp[r].clone()
        b1 = [x[r].clone() for x in bufs]
        acc1 = torch.zeros(nw, dtype=torch.bool)
        cnt1 = torch.zeros(nw, dtype=torch.int32)
        accept_select_plain(q[r], f[r], lp_q[r], c1, l1, split, ns, acc1,
                            cnt1, seed=keys.seeds[r], offset=4,
                            log_u=None if lu is None else lu[r],
                            blobs=[(x[r], y) for x, y in zip(news, b1)])
        for got, want in zip((c[r], l[r], acc[r], cnt[r],
                              *(x[r] for x in b)),
                             (c1, l1, acc1, cnt1, *b1)):
            assert torch.equal(got, want)
    assert 0 < int(acc.sum()) < T * ng


def blob_checks(s, n):
    ll = np.asarray(s.get_log_like())
    scalar, vec = s.get_blobs()
    assert np.asarray(scalar).shape == (n, 3, 16)
    assert np.asarray(vec).shape == (n, 3, 16, 2)
    # Every rung and stored step: a swap that moved a walker without its
    # blobs would break these.
    np.testing.assert_array_equal(np.asarray(scalar), 2.0 * ll)
    np.testing.assert_array_equal(np.asarray(vec), s.get_chain())
    return scalar


@pytest.mark.parametrize("backend", [PTBackend, PTDeviceBackend])
def test_pt_blobs_memory_and_device_backend(backend):
    """The twins of test_pt_parity.py:222 and :253."""
    be = backend()
    s = PTSampler(3, 16, 2, ll_blobs, lp_box, seed=0, backend=be,
                  device="cpu")
    s.run_mcmc(p0(), 30)
    scalar = blob_checks(s, 30)
    s0 = s.get_blobs(temp=0)
    np.testing.assert_array_equal(np.asarray(s0[0]), scalar[:, 0])
    assert s.get_blobs(discard=10, thin=4)[1].shape == (5, 3, 16, 2)
    s.run_mcmc(None, 10)
    blob_checks(s, 40)
    assert s.get_last_sample().blobs is not None
    if backend is PTDeviceBackend:
        host = be.to_host()
        np.testing.assert_array_equal(host.get_blobs()[0],
                                      s.get_blobs()[0])


def test_get_blobs_has_the_jax_packages_layout():
    """Same structure, shapes and dtypes as a JAX run's ``get_blobs``,
    whole and by rung."""
    s = PTSampler(3, 16, 2, ll_blobs, lp_box, seed=0, device="cpu")
    s.run_mcmc(p0(), 5)
    j = JPTSampler(3, 16, 2, j_ll_blobs, j_lp_box, seed=0)
    j.run_mcmc(p0(), 5)
    for temp in (None, 1):
        got, want = s.get_blobs(temp=temp), j.get_blobs(temp=temp)
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            assert np.shape(a) == np.shape(b)
            assert np.asarray(a).dtype == np.asarray(b).dtype


def test_jax_state_with_blobs_continues_in_the_port():
    j = JPTSampler(3, 16, 2, j_ll_blobs, j_lp_box, seed=1)
    st = j.run_mcmc(p0(), 4)
    port = pt_state_from_numpy(
        np.asarray(st.coords), np.asarray(st.log_like),
        np.asarray(st.log_prior), seed=5, device="cpu",
        blobs=tuple(np.asarray(b) for b in st.blobs))
    s = PTSampler(3, 16, 2, ll_blobs, lp_box, seed=5, device="cpu")
    s.run_mcmc(port, 6)
    blob_checks(s, 6)


def test_pt_no_blobs_unchanged():
    s = PTSampler(3, 8, 2, lambda x: -0.5 * torch.sum(x**2), lp_box,
                  seed=0, device="cpu")
    s.run_mcmc(p0(3, 8), 5)
    assert s.get_blobs() is None and s.get_last_sample().blobs is None


def test_pt_blobless_resume_of_blobful_chain_rejected():
    """The twin of test_tempering.py:472; the reverse direction (a state
    without blobs whose likelihood returns some) evaluates them."""
    be = PTBackend()
    c0 = np.random.default_rng(1).normal(size=(2, 8, 2))
    s1 = PTSampler(2, 8, 2, lambda x: (-0.5 * torch.sum(x**2), x.sum()),
                   lambda x: torch.zeros(()), seed=0, backend=be,
                   device="cpu")
    s1.run_mcmc(c0, 4)
    s2 = PTSampler(2, 8, 2, lambda x: -0.5 * torch.sum(x**2),
                   lambda x: torch.zeros(()), seed=0, backend=be,
                   device="cpu")
    with pytest.raises(ValueError, match="inconsistent use of blobs"):
        s2.run_mcmc(None, 3)
    s3 = PTSampler(2, 8, 2, ll_blobs, lambda x: torch.zeros(()), seed=0,
                   device="cpu")
    st = s3._prepare_state(pt_state_from_numpy(
        c0, -0.5 * (c0**2).sum(-1), np.zeros((2, 8)), device="cpu"))
    np.testing.assert_array_equal(st.blobs[1].numpy(),
                                  c0.astype(np.float32))


def chunk(k, T=2, nw=4, nd=3, blobs=None):
    return dict(coords=np.zeros((k, T, nw, nd)),
                log_like=np.zeros((k, T, nw)),
                log_prior=np.zeros((k, T, nw)),
                accepted=np.zeros((k, T, nw), np.int32),
                swaps_accepted=np.zeros(T - 1, np.int64),
                swaps_proposed=np.zeros(T - 1, np.int64),
                random_state=None, betas=np.array([1.0, 0.5]), blobs=blobs)


def test_pregrown_backend_allocates_first_blobs():
    """The twin of test_pt_backends.py:169."""
    b = PTBackend()
    b.reset(2, 4, 3)
    b.grow(10)
    b.grow(5, {"s": np.zeros((2, 4), np.float32)})
    assert b.blobs is not None and b.blobs["s"].shape == (10, 2, 4)
    b.save_chunk(**chunk(5, blobs={"s": np.ones((5, 2, 4), np.float32)}))
    assert b.iteration == 5
    np.testing.assert_array_equal(b.get_blobs()["s"], 1.0)


def test_pt_max_chunk_counts_blob_bytes():
    """The twin of test_pt_backends.py:202, for both schedules."""
    for adaptive in (False, True):
        s = PTSampler(2, 8, 2, ll_blobs, lp_box, seed=0, device="cpu",
                      io_chunk_bytes=1 << 16, adaptive=adaptive)
        big = {"resid": np.zeros((2, 8, 500), np.float64)}
        assert s._max_chunk(big) < s._max_chunk()


@pytest.mark.parametrize("backend", ["memory", "device", "hdf"])
def test_pt_inconsistent_blob_use_rejected(backend, tmp_path):
    """The twin of test_pt_backends.py:214."""
    from emcee_tpu_torch.backends import PTHDFBackend

    b = {"memory": PTBackend, "device": PTDeviceBackend,
         "hdf": lambda: PTHDFBackend(str(tmp_path / "pt.h5"))}[backend]()
    b.reset(2, 4, 3)
    b.save_chunk(**chunk(2, blobs={"s": np.ones((2, 2, 4), np.float32)}))
    with pytest.raises(ValueError, match="inconsistent use of blobs"):
        b.save_chunk(**chunk(2, blobs=None))
