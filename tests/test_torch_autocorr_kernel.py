"""K6, the diagnostics' fused chains (``emcee_tpu_torch/ops/
autocorr_kernel.py``), against the JAX package.

On the CPU each K6 wrapper runs its plain version, so these tests hold
the plain versions, and the kernel route's layouts, chunks, walker groups,
key maps, orders and tie groups composed as the card runs them, against
``emcee_tpu/ops/autocorr.py`` on the same numpy inputs (JAX on the CPU,
tests/conftest.py).  Tolerances and their reasons:

* ACFs: atol 1e-5.  JAX computes in float32 (reference defect R2); an
  ACF is normalised to 1 at lag 0, so float32 FFT rounding is a few 1e-7
  of it, summed over at most a few hundred walkers.
* tau (Sokal and Geyer), the PSRF and R-hat: rtol 1e-4, the float32
  tolerance of ``tests/test_torch_autocorr.py`` (the cumulative and pair
  sums over the lags, the moments of 1e3-1e4 draws, all float32 in JAX);
  atol 1e-6 beside it where a tau is near 0 (``n_t`` 2).
* Windows, ranks, orders and keys: exact.  They are integers (a rank is
  a mean of two positions); the float32 JAX positions are exact at these
  sizes.
* Within the port: the kernel route's plain versions against the plain
  route (today's torch code), rtol 1e-10 for the float64 walker sums and
  moments, exact for the orders, the tie groups and the medians.

``ConvergenceMonitor(rhat_threshold=1.01).update`` of the port on one
seeded chain as a tensor (through the kernel route) and of JAX on the same
chain as a ``jax.Array`` must agree on tau (rtol 1e-4), R-hat (rtol
1e-4) and the decision, for both tau methods.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu import monitor as jmonitor
from emcee_tpu.ops import autocorr as jac

from emcee_tpu_torch import monitor as tmonitor
from emcee_tpu_torch.ops import autocorr as ac
from emcee_tpu_torch.ops import autocorr_kernel as ak

RTOL = 1e-4
ACF_ATOL = 1e-5
TAU_ATOL = 1e-6
PORT_RTOL = 1e-10


def ar1(n, shape, a=0.9, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = np.empty((n,) + shape)
    x[0] = rng.normal(size=shape) / np.sqrt(1 - a * a)
    for i in range(1, n):
        x[i] = a * x[i - 1] + rng.normal(size=shape)
    return x.astype(dtype)


@pytest.fixture
def kernel_route(monkeypatch):
    """Route CPU tensors through the kernel route (each wrapper's plain
    version), as CUDA tensors go."""
    monkeypatch.setattr(ac, "_on_kernels",
                        lambda x: isinstance(x, torch.Tensor))


# -- K6a, K6b ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_t", [1, 2, 3, 33, 200])
def test_acf_batched_matches_jax(dtype, n_t):
    x = ar1(n_t, (4, 2), seed=n_t, dtype=dtype)
    got = ac._acf_batched(torch.from_numpy(x)).numpy()
    want = np.asarray(jac._acf_batched(jnp.asarray(x)))
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=ACF_ATOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_walker_mean_acf_chunks_match_jax(dtype):
    """A budget of a few walkers forces the plain route and the kernel
    route through several chunks (and the kernel route's partials through
    several walker groups)."""
    x = ar1(150, (23, 3), seed=1, dtype=dtype)
    want = np.asarray(jac._walker_mean_acf(jnp.asarray(x)))
    budget = 20 * 2 * 256 * 3 * 2 * x.itemsize  # 20 walkers a chunk
    plan = ak.acf_plan(150, 23, 3, x.itemsize, ak.CPU_SMS, budget)
    assert plan.chunk == 20 and plan.groups > 1
    t = torch.from_numpy(x)
    plain = ac._walker_mean_acf(t, budget).numpy()
    f, _ = ac._acf_kernels(t, "sokal", 5.0, budget)
    np.testing.assert_allclose(plain, want, rtol=0, atol=ACF_ATOL)
    np.testing.assert_allclose(f.numpy(), want, rtol=0, atol=ACF_ATOL)
    np.testing.assert_allclose(f.numpy(), ac._walker_mean_acf(
        t.double(), budget).numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_t", [2, 3, 33, 400])
@pytest.mark.parametrize("method", ["sokal", "geyer"])
def test_tau_of_the_kernel_route_matches_jax(n_t, method):
    x = ar1(n_t, (16, 3), a=0.7, seed=n_t)
    t = torch.from_numpy(x)
    jf = jac._walker_mean_acf(jnp.asarray(x))
    if method == "sokal":
        want = np.asarray(jac._tau_from_f(jf, 5.0, n_t)[0])
    else:
        want = np.asarray(jac._tau_geyer(jf))
    _, tau = ac._acf_kernels(t, method, 5.0, budget=6000)
    np.testing.assert_allclose(tau.numpy(), want, rtol=RTOL, atol=TAU_ATOL)
    plain = ac.integrated_time(t, method=method, quiet=True)
    np.testing.assert_allclose(tau.numpy(), plain, rtol=RTOL,
                               atol=TAU_ATOL)


def test_tau_from_f_matches_jax_windows():
    """Sokal's window on designed ACFs: decaying (the window ends inside),
    one whose mask never fails (numpy's argmin gives window 0, tau 1), a
    NaN column (the mask never holds: the last lag), and a negative tail.
    ``tau_window``'s plain version gives JAX's taus and windows."""
    n_t = 40
    lags = np.arange(n_t)
    f = np.stack([0.8 ** lags, np.ones(n_t), np.full(n_t, np.nan),
                  np.where(lags < 3, 1.0 - lags / 3, -0.05)], axis=1)
    jt, jw = jac._tau_from_f(jnp.asarray(f, jnp.float32), 5.0, n_t)
    tau, win = ak.sokal_plain(f, 5.0)
    np.testing.assert_array_equal(win, np.asarray(jw))
    np.testing.assert_allclose(tau, np.asarray(jt), rtol=RTOL)
    assert win[1] == 0 and tau[1] == 1.0 and win[2] == n_t - 1
    np.testing.assert_allclose(ac._tau_from_f(f, 5.0), tau, rtol=0)
    part = torch.from_numpy(f * 7.0)[None]  # one group's sum of 7 walkers
    out = [torch.empty(n_t, 4, dtype=torch.float64),
           torch.empty(4, dtype=torch.float64),
           torch.empty(4, dtype=torch.int64)]
    ak.tau_window_plain(part, 7, "sokal", 5.0, *out)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(jw))
    np.testing.assert_allclose(out[1].numpy(), np.asarray(jt), rtol=RTOL)


def test_tau_geyer_matches_jax():
    """Geyer on designed ACFs: decaying, a first pair not positive (the
    floor at 1 / log10(n_t)), a pair sum rising (the running minimum)."""
    n_t = 50
    lags = np.arange(n_t)
    f = np.stack([0.9 ** lags, np.where(lags == 0, 1.0, -1.2),
                  np.where(lags < 6, 1.0, 0.02) * 0.95 ** lags], axis=1)
    want = np.asarray(jac._tau_geyer_device(jnp.asarray(f, jnp.float32)))
    tau, k_stop = ak.geyer_plain(torch.from_numpy(f))
    np.testing.assert_allclose(tau.numpy(), want, rtol=RTOL)
    assert tau[1] == 1.0 / np.log10(n_t) and k_stop[1] == 0
    np.testing.assert_allclose(ac._tau_geyer(torch.from_numpy(f)).numpy(),
                               tau.numpy(), rtol=0)
    assert np.isnan(ac._tau_geyer(torch.ones(1, 3)).numpy()).all()


@pytest.mark.parametrize("view", ["thinned", "walkers", "thinned walkers"])
def test_acf_views_equal_contiguous_copies(view, kernel_route):
    x = torch.from_numpy(ar1(300, (40, 3), seed=4))
    v = {"thinned": x[1::3], "walkers": x[:, 7:33],
         "thinned walkers": x[::2, 5:30]}[view]
    for method in ("sokal", "geyer"):
        got = ac._acf_kernels(v, method, 5.0, budget=20000)
        want = ac._acf_kernels(v.contiguous(), method, 5.0, budget=20000)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    np.testing.assert_allclose(
        ac.integrated_time(v, quiet=True),
        jac.integrated_time(v.numpy(), quiet=True), rtol=RTOL)


def test_acf_center_and_reduce_layouts():
    """acf_center's series are walker-major and zero-padded; acf_reduce's
    groups of walkers add to the plain walker sum."""
    x = torch.from_numpy(ar1(10, (6, 2), seed=5, dtype=np.float64))
    out = torch.full((4 * 2, 32), 7.0, dtype=torch.float64)
    ak.acf_center(x, 1, 4, out)
    for w in range(4):
        for j in range(2):
            s = x[:, 1 + w, j]
            np.testing.assert_allclose(out[w * 2 + j, :10].numpy(),
                                       (s - s.mean()).numpy(), atol=1e-14)
    assert not out[:, 10:].any()
    acf = torch.fft.irfft(ak.acf_power(torch.fft.rfft(out, dim=-1)), n=32,
                          dim=-1)
    part = torch.empty(3, 10, 2, dtype=torch.float64)
    ak.acf_reduce(acf, part, 10, 2, 4, 2, True)
    assert not part[2].any()  # the third group has no walker
    want = ac._acf_batched(x[:, 1:5]).sum(dim=1)
    np.testing.assert_allclose(part.sum(0).numpy(), want.numpy(), atol=1e-12)
    ak.acf_reduce(acf, part, 10, 2, 4, 2, False)
    np.testing.assert_allclose(part.sum(0).numpy(), 2 * want.numpy(),
                               atol=1e-12)


def test_acf_plan_fills_the_card():
    for n_t, n_w, n_d in ((200, 100_000, 5), (100, 4000, 5), (1, 1, 1),
                          (20_000, 30, 2), (3, 7, 1)):
        p = ak.acf_plan(n_t, n_w, n_d, 4, 132)
        assert p.m2 == 2 * ak.next_pow_two(n_t) and 1 <= p.chunk <= n_w
        assert p.groups * p.wg >= p.chunk > (p.groups - 1) * p.wg
        assert p.groups <= 65535
    p = ak.acf_plan(200, 100_000, 5, 4, 132)
    assert p.chunk == 13107 and p.groups * 7 >= 4 * 132


# -- K6c, K6d ---------------------------------------------------------------


def sorted_order(lo, hi):
    """K16's sorted words of the keys ``lo`` (and ``hi``) and the flat
    order they hold (row ``j`` of ``S`` at ``j S``)."""
    sw = torch.empty_like(lo)
    sh = None if hi is None else torch.empty_like(hi)
    ak.stable_order(lo, hi, sw, sh)
    d, S = lo.shape
    order = (sw & 0xFFFFFFFF) + torch.arange(0, d * S, S)[:, None]
    return sw, sh, order.reshape(-1)


def test_order_keys_are_monotone_over_specials():
    for dt, it in ((np.float32, np.uint32), (np.float64, np.uint64)):
        fi = np.finfo(dt)
        vals = np.array([-np.inf, -fi.max, -1.5, -fi.tiny,
                         -fi.smallest_subnormal, -0.0, 0.0,
                         fi.smallest_subnormal, fi.tiny, 1.0, fi.max, np.inf,
                         np.nan], dtype=dt)
        neg_nan = np.array([np.nan], dtype=dt).view(it) | it(1 << (
            8 * np.dtype(dt).itemsize - 1))
        vals = np.concatenate([vals, neg_nan.view(dt)])
        lo, hi = ak.order_keys_plain(torch.from_numpy(vals))
        key = lo.numpy().astype(np.uint64)
        if hi is not None:
            key = key | (hi.numpy().astype(np.uint64) << np.uint64(32))
        assert key[5] == key[6]  # -0.0 ties +0.0
        assert (key[1:6] > key[:5]).all() and (key[7:12] > key[6:11]).all()
        assert key[12] == key[13] > key[11]  # every NaN, above +inf
        assert key[12] == (0xFFFFFFFF if hi is None else 2**64 - 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_zero_and_nan_orders_equal_torch_sort(dtype):
    """K16's order of the keys (through its plain version here) equals
    torch.sort(stable=True) of the values: -0.0 and +0.0 keep their index
    order, NaNs sort last in index order; float64 by two passes."""
    rng = np.random.default_rng(6)
    v = np.round(rng.normal(size=(3, 500)) * 2).astype(np.float64)
    v[rng.random(v.shape) < 0.3] = 0.0
    v[rng.random(v.shape) < 0.2] = -0.0
    v[rng.random(v.shape) < 0.05] = np.nan
    v[0, :4] = [np.inf, -np.inf, np.nan, -0.0]
    t = torch.from_numpy(v).to(dtype)
    draws = ak.Draws(t.T[:, None, :], 500, 1, 1, 0)  # (500, 1, 3)
    lo = torch.empty(3, 500, dtype=torch.int64)
    hi = torch.empty_like(lo) if dtype == torch.float64 else None
    ak.rank_keys(draws, lo, hi)
    sw, sh, order = sorted_order(lo, hi)
    want = torch.sort(t, dim=1, stable=True).indices + torch.arange(
        0, 1500, 500)[:, None]
    assert torch.equal(order, want.reshape(-1))
    np_order = np.argsort(v.astype(np.float64), axis=1, kind="stable")
    assert np.array_equal(order.view(3, 500).numpy() % 500, np_order)
    # the sorted words carry each position's key
    assert torch.equal((sw >> 32) & 0xFFFFFFFF, lo.gather(1, sw & 0xFFFFFFFF))
    if sh is not None:
        assert torch.equal((sh >> 32) & 0xFFFFFFFF,
                           hi.gather(1, sw & 0xFFFFFFFF))


def test_float64_two_pass_order_equals_a_stable_argsort():
    """Values that share their 64-bit keys' high word and differ in the
    low one, and the reverse: the low-word pass then the high-word pass
    give the stable argsort."""
    rng = np.random.default_rng(7)
    base = rng.normal(size=40)
    v = np.concatenate([base, np.nextafter(base, np.inf), base,
                        base * 2 ** 40, -base])
    v = v[rng.permutation(v.size)]
    t = torch.from_numpy(v)[:, None, None]
    draws = ak.Draws(t, v.size, 1, 1, 0)
    lo = torch.empty(1, v.size, dtype=torch.int64)
    hi = torch.empty_like(lo)
    ak.rank_keys(draws, lo, hi)
    _, _, order = sorted_order(lo, hi)
    assert np.array_equal(order.numpy(), np.argsort(v, kind="stable"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stable_order_in_parameter_groups(dtype, monkeypatch):
    """Where the byte budget, or one K16 call, cannot take every
    parameter's draws, the rank passes take the parameters in groups
    (each group's keys sorted by one call), the buffers reused from group
    to group: the same normal scores, bit for bit, and the same R-hat as
    one group (rtol 1e-12: the plain PSRF's reductions on the CPU may
    round otherwise for another number of parameters; phase 24 of
    chip_smoke.py holds the kernels' bit for bit on the card)."""
    x = torch.from_numpy(np.round(ar1(41, (6, 5), seed=16) * 2)).to(dtype)
    f64 = dtype == torch.float64
    S = 20 * 12
    per = S * ak.RHAT_BYTES[f64]
    assert ak.rhat_group(5, S, f64) == 5
    assert ak.rhat_group(5, S, f64, 2 * per + 1) == 2
    assert ak.rhat_group(5, S, f64, 1) == 1  # one at least
    want = ac._rhat_kernels(x, True, True).numpy()
    scores = []
    real = ak.psrf

    def psrf(draws, out, prior=False):
        scores.append(draws.x.permute(2, 0, 1).reshape(draws.d, -1).clone())
        return real(draws, out, prior)

    monkeypatch.setattr(ak, "psrf", psrf)
    for budget in (None, 2 * per, per):
        scores.clear()
        got = ac._rhat_kernels(x, True, True, *([budget] if budget else []))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
        if budget is None:
            whole = scores[:]
        else:  # each group's bulk and tail scores, in parameter order
            k = budget // per
            for tail in (0, 1):
                got_z = torch.cat(scores[tail::2])
                assert torch.equal(got_z, whole[tail]), (budget, tail)
            assert len(scores) == 2 * -(-5 // k)
    monkeypatch.setattr(ak, "SORT_KEYS_MAX", 2 * S)  # groups of 2, 2, 1
    assert ak.rhat_group(5, S, f64) == 2
    np.testing.assert_allclose(ac._rhat_kernels(x, True, True).numpy(),
                               want, rtol=1e-12)
    assert torch.equal(ac._rhat_kernels(x, True, False),
                       ac._rhat_kernels(x, True, False, 1))


def test_rank_passes_refuse_more_draws_than_k16_sorts(monkeypatch):
    """K16 sorts at most ``DRAWS_MAX`` draws a parameter: the rank passes
    refuse more, while the raw PSRF, which does not sort, takes them."""
    x = torch.from_numpy(ar1(41, (8, 2), a=0.5, seed=17))
    monkeypatch.setattr(ak, "DRAWS_MAX", 41 * 8 - 1)
    with pytest.raises(ValueError, match="K16 sorts"):
        ac._rhat_kernels(x, False, True)
    got = ac._rhat_kernels(x, False, False).numpy()
    np.testing.assert_allclose(got, jac.rhat(jnp.asarray(x.numpy()),
                                             split=False,
                                             rank_normalized=False),
                               rtol=RTOL)
    ac._rhat_kernels(x, True, True)  # split: 20 x 16 draws, fewer


@pytest.mark.parametrize("T, n", [(1, 1), (3, 700), (2, 5000)])
def test_sorted_words_hold_the_stable_order(T, n):
    """K16's sorted words (through the plain version here): each is the
    key at its sorted position above the position in its segment, and
    the order they give, and the order written beside them, equal
    group_order's with one split."""
    from emcee_tpu_torch.ops import shuffle_kernel as sk

    rng = np.random.default_rng(T * n)
    keys = torch.from_numpy(rng.integers(0, 2**32, size=(T, n)) // 7)
    keys[:, ::5] = 2**32 - 1  # ties, and the top key
    words = torch.empty_like(keys)
    order = torch.empty(T * n, dtype=torch.int64)
    sk.sorted_words(keys, words, order)
    want = sk.group_order(keys, 1)
    pos = words & 0xFFFFFFFF
    assert torch.equal(order, want)
    assert torch.equal((pos + torch.arange(0, T * n, n)[:, None])
                       .reshape(-1), want)
    assert torch.equal((words >> 32) & 0xFFFFFFFF, keys.gather(1, pos))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_avg_ranks_and_tie_groups_match_jax(dtype):
    rng = np.random.default_rng(8)
    v = np.round(rng.normal(size=(600, 3)) * 3).astype(dtype)  # ties
    v[:, 2] = 4.0  # all tied
    ranks, median = ac._avg_ranks(torch.from_numpy(v))
    for j in range(3):
        want = np.asarray(jac._avg_ranks_1d(jnp.asarray(v[:, j])))
        np.testing.assert_array_equal(ranks[:, j].numpy(), want)
    np.testing.assert_array_equal(median.numpy(), np.median(v, axis=0))
    # rank_scores' groups: grp[k] the group's first position where k does
    # not start it, else its last; (first + last) / 2 + 1 is the rank.
    draws = ak.Draws(torch.from_numpy(v)[:, None, :], 600, 1, 1, 0)
    lo = torch.empty(3, 600, dtype=torch.int64)
    hi = torch.empty_like(lo) if dtype == np.float64 else None
    ak.rank_keys(draws, lo, hi)
    sw, sh, order = sorted_order(lo, hi)
    grp = torch.empty(1800, dtype=torch.int32)
    z = torch.empty(3, 600, dtype=torch.float64)
    med = torch.empty(3, dtype=torch.from_numpy(v).dtype)
    ak.rank_scores(draws, sw, sh, grp, z, med)
    k = torch.arange(600).repeat(3)
    g = grp.long()
    row = torch.arange(3).repeat_interleave(600) * 600
    first = torch.where(g >= k, k, g)
    last = torch.where(g >= k, g, grp[row + g.clamp(0, 599)].long())
    r_sorted = ((first + last + 2).double() * 0.5).view(3, 600)
    got = torch.empty(3, 600, dtype=torch.float64)
    got.view(-1)[order] = r_sorted.reshape(-1)
    assert torch.equal(got.T, ranks)
    assert torch.equal(med, median)
    assert torch.equal(z, torch.special.ndtri((ranks.T - 0.375) / 600.25))


def test_psrf_matches_jax():
    x = ar1(300, (6, 3), a=0.5, seed=9)
    x[:, 0, 1] += 1.0
    want = np.asarray(jac._psrf_device(jnp.asarray(x)))
    np.testing.assert_allclose(ac._psrf_device(torch.from_numpy(x)).numpy(),
                               want, rtol=RTOL)
    out = torch.empty(3, dtype=torch.float64)
    ak.psrf(ak.split_draws(torch.from_numpy(x), False), out)
    np.testing.assert_allclose(out.numpy(), want, rtol=RTOL)
    ak.psrf(ak.split_draws(torch.from_numpy(x[:, :3].copy()), False), out,
            prior=True)
    np.testing.assert_allclose(out.numpy(), np.maximum(want, np.asarray(
        jac._psrf_device(jnp.asarray(x[:, :3])))), rtol=RTOL)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("rank_normalized", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rhat_of_the_kernel_route_matches_jax(split, rank_normalized,
                                              dtype):
    x = ar1(201, (10, 3), a=0.5, seed=10, dtype=dtype)  # an odd length
    x[:, 0, 1] += 0.8
    x[:, :, 2] = np.round(x[:, :, 2] * 2)  # ties
    t = torch.from_numpy(x)
    got = ac._rhat_kernels(t, split, rank_normalized).numpy()
    want = np.asarray(jac.rhat(jnp.asarray(x), split=split,
                               rank_normalized=rank_normalized))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    plain = ac.rhat(t, split=split, rank_normalized=rank_normalized)
    np.testing.assert_allclose(got, plain, rtol=PORT_RTOL)
    if not rank_normalized:
        return
    # the device path's ranks and median against _rhat_device's pieces
    h = 100 if split else 201
    block = torch.cat([t[:h], t[201 - h:]], 1) if split else t
    z, med = ac._rank_normalize_device(block)
    draws = ak.split_draws(t, split)
    assert torch.equal(draws.block(), block)
    d, S = 3, draws.S
    lo = torch.empty(d, S, dtype=torch.int64)
    hi = torch.empty_like(lo) if dtype == np.float64 else None
    ak.rank_keys(draws, lo, hi)
    sw, sh, _ = sorted_order(lo, hi)
    zk = torch.empty(d, S, dtype=torch.float64)
    mk = torch.empty(d, dtype=t.dtype)
    ak.rank_scores(draws, sw, sh, torch.empty(d * S, dtype=torch.int32),
                   zk, mk)
    assert torch.equal(mk, med)
    assert torch.equal(zk, z.reshape(S, d).T)


def test_all_tied_column_gives_nan(kernel_route):
    x = ar1(60, (8, 3), seed=11)
    x[:, :, 0] = 1.0  # collapsed: every draw tied
    x[:, :, 1] = np.arange(60)[:, None]  # collapsed across walkers only
    got = ac.rhat(torch.from_numpy(x))
    want = np.asarray(jac.rhat(jnp.asarray(x)))
    assert np.isnan(got[0]) and np.isnan(want[0])
    np.testing.assert_allclose(got[1:], want[1:], rtol=RTOL)


def test_nan_and_signed_zero_draws_match_jax(kernel_route):
    rng = np.random.default_rng(12)
    x = np.round(ar1(80, (6, 2), seed=12) * 2)
    x[rng.random(x.shape) < 0.3] = -0.0
    x[3, 2, 1] = np.nan
    got = ac.rhat(torch.from_numpy(x))
    want = np.asarray(jac.rhat(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("view", ["second half", "thinned", "walkers"])
def test_rhat_views_equal_contiguous_copies(view, kernel_route):
    x = torch.from_numpy(ar1(101, (12, 2), a=0.5, seed=13))
    v = {"second half": x[50:], "thinned": x[::2], "walkers": x[:, 2:9]}[view]
    for split in (True, False):
        for rn in (True, False):
            assert torch.equal(ac._rhat_kernels(v, split, rn),
                               ac._rhat_kernels(v.contiguous(), split, rn))
    np.testing.assert_allclose(ac.rhat(v), jac.rhat(jnp.asarray(v.numpy())),
                               rtol=RTOL)


def test_split_draws_read_both_halves():
    x = torch.arange(7 * 3 * 2, dtype=torch.float32).view(7, 3, 2)
    d = ak.split_draws(x, True)
    assert (d.h, d.m, d.C, d.shift, d.S) == (3, 3, 6, 4, 18)
    assert torch.equal(d.block(), torch.cat([x[:3], x[4:]], 1))
    assert torch.equal(ak.pooled_values(d),
                       torch.cat([x[:3], x[4:]], 1).reshape(18, 2).T)
    u = ak.split_draws(x, False)
    assert torch.equal(u.block(), x) and u.S == 21


# -- the slice as a whole -----------------------------------------------------


@pytest.mark.parametrize("method", ["sokal", "geyer"])
@pytest.mark.parametrize("n,want", [(2000, True), (120, False)])
def test_monitor_matches_jax(method, n, want, kernel_route, monkeypatch):
    """One check of ``ConvergenceMonitor(rhat_threshold=1.01)`` on the
    same chain: the port's tensor through the kernel route, JAX's
    ``jax.Array`` through its device path."""
    for mod in (ac, jac):
        monkeypatch.setattr(mod, "integrated_time", functools.partial(
            mod.integrated_time, method=method))
    x = ar1(n, (32, 3), a=0.5, seed=14)
    port = tmonitor.ConvergenceMonitor(rhat_threshold=1.01)
    jaxm = jmonitor.ConvergenceMonitor(rhat_threshold=1.01)
    got = port.update(torch.from_numpy(x))
    ref = jaxm.update(jnp.asarray(x))
    assert got == ref == want
    np.testing.assert_allclose(port.tau, np.asarray(jaxm.tau), rtol=RTOL)
    np.testing.assert_allclose(port.rhat, np.asarray(jaxm.rhat), rtol=RTOL)
    # the plain route on the CPU tensor agrees too
    monkeypatch.setattr(ac, "_on_kernels", lambda x: False)
    plain = tmonitor.ConvergenceMonitor(rhat_threshold=1.01)
    assert plain.update(torch.from_numpy(x)) == want
    np.testing.assert_allclose(plain.tau, port.tau, rtol=RTOL)
    np.testing.assert_allclose(plain.rhat, port.rhat, rtol=PORT_RTOL)


def test_entry_points_take_the_kernel_route(kernel_route):
    """integrated_time, ess, rhat and function_1d of a tensor launch every
    K6 wrapper (their plain versions here) and K16."""
    from emcee_tpu_torch.ops import shuffle_kernel as sk

    fns = (ak.acf_center, ak.acf_power, ak.acf_reduce, ak.tau_window,
           ak.rank_keys, ak.rank_scores, ak.psrf)
    for fn in fns + (sk.group_order,):
        fn.launches = 0
    x = torch.from_numpy(ar1(400, (8, 2), seed=15))
    ac.integrated_time(x, quiet=True)
    ac.ess(x, method="geyer", quiet=True)
    ac.rhat(x)
    f1 = ac.function_1d(x[:, 0, 0])
    np.testing.assert_allclose(f1, jac.function_1d(x[:, 0, 0].numpy()),
                               rtol=0, atol=ACF_ATOL)
    assert all(fn.launches == 0 for fn in fns + (sk.group_order,))  # plain
    # on the CPU the wrappers take the plain versions and count nothing;
    # the route calls each wrapper: count the calls instead
    calls = {fn.__name__: 0 for fn in fns}
    for fn in fns:
        def counted(*a, _fn=fn, **kw):
            calls[_fn.__name__] += 1
            return _fn(*a, **kw)
        setattr(ak, fn.__name__, counted)
    try:
        ac.integrated_time(x, quiet=True)
        ac.rhat(x)
    finally:
        for fn in fns:
            setattr(ak, fn.__name__, fn)
    assert calls == {"acf_center": 1, "acf_power": 1, "acf_reduce": 1,
                     "tau_window": 1, "rank_keys": 2, "rank_scores": 2,
                     "psrf": 2}
