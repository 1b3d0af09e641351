"""DE and DE-snooker on every rung of the port's tempered ladder: K5a and
K5b with the rung axis (``emcee_tpu_torch/ops/de_kernel.py``,
``ops/snooker_kernel.py``), the counterpart of the JAX package's
``jax.vmap`` of the move over the rungs
(``emcee_tpu/parallel/tempering.py:532-541``).

Against the JAX package, rung by rung: K5a's plain version on the rung
axis against ``DEMove.get_proposal`` under each rung's own key, whose
draws are reproduced (``tests/test_torch_de.py`` ``jax_de_draws``) and
injected as ``(T, ng)`` rows (rtol = atol = 1e-6, the factor exactly 0);
K5b's against ``DESnookerMove.get_proposal``, the roll uniforms given to
both as ``extra`` and the random draws reproduced as
``tests/test_torch_de_snooker.py`` does (its tolerances: the two row sums
run in another order in XLA).  Exact within the port, bit for bit: the
plain versions on the rung axis against the one-ensemble plain versions
under ``keys.seeds[r]``, injected and from the stream; and ``PTSampler``
proposing every rung at once against the forced per-rung loop (the
private ``_batched`` switch), with user blobs, tuning and mixtures.  Then
a statistical oracle: the DE + snooker mixture on every rung of
``test_torch_tempering.py``'s bimodal target keeps both modes in the cold
rung.  JAX runs on the CPU (tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu.model import Model as JModel
from emcee_tpu.moves import DEMove as JDEMove
from emcee_tpu.moves import DESnookerMove as JSnookerMove

from emcee_tpu_torch import PTSampler, moves
from emcee_tpu_torch.ops.de_kernel import de_gamma0, de_propose_plain
from emcee_tpu_torch.ops.philox import DeviceOffset, rung_keys
from emcee_tpu_torch.ops.snooker_kernel import snooker_propose_plain
from tests.test_torch_de import jax_de_draws
from tests.test_torch_de_snooker import jax_random_draws

RTOL, ATOL = 1e-6, 1e-6  # K5a, as tests/test_torch_de.py
SN_RTOL = SN_ATOL = 1e-5  # K5b, as tests/test_torch_de_snooker.py
SN_F_ATOL = 1e-4


def rung_parts(coords, r, split, ns):
    """Rung ``r``'s split group and the other groups, as JAX takes them."""
    ng = coords.shape[1] // ns
    bl = [coords[r, j * ng:(j + 1) * ng] for j in range(ns)]
    return jnp.asarray(bl[split]), tuple(jnp.asarray(b) for j, b in
                                         enumerate(bl) if j != split)


def stack(draws):
    """One ``(T, ...)`` tensor of each keyword of the rungs' draws."""
    return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}


@pytest.mark.parametrize("pair_mode", ["roll", "random"])
@pytest.mark.parametrize("tuned", [False, True])
@pytest.mark.parametrize("nsplits", [2, 3])
def test_k5a_rung_axis_matches_jax_get_proposal(pair_mode, tuned, nsplits):
    rng = np.random.default_rng(60 + nsplits + 2 * tuned)
    T, nw, nd, sigma = 3, 24, 4, 0.3
    ng = nw // nsplits
    coords = rng.normal(size=(T, nw, nd)).astype(np.float32)
    scale = np.array([0.7, 1.3, 1.0], np.float32) if tuned else None
    jmove = JDEMove(sigma=sigma, pair_mode=pair_mode, nsplits=nsplits)
    jmodel = JModel(compute_log_prob=None, nwalkers=nw)
    for split in range(nsplits):
        keys = [jax.random.key(300 + 10 * r + split) for r in range(T)]
        q, f = de_propose_plain(
            torch.tensor(coords), split, nsplits,
            gamma0=de_gamma0(None, nd), sigma=sigma, pair_mode=pair_mode,
            scale=None if scale is None else torch.tensor(scale),
            **stack([jax_de_draws(k, pair_mode, ng, nw - ng) for k in keys]))
        assert q.shape == (T, ng, nd) and f.shape == (T, ng)
        for r in range(T):
            s, c_parts = rung_parts(coords, r, split, nsplits)
            kw = {} if scale is None else dict(scale=jnp.float32(scale[r]))
            jq, jf = jmove.get_proposal(keys[r], s, c_parts, jmodel, **kw)
            np.testing.assert_allclose(q[r].numpy(), np.asarray(jq), RTOL,
                                       ATOL)
            np.testing.assert_array_equal(f[r].numpy(), np.asarray(jf))
            assert not f[r].any()


@pytest.mark.parametrize("pair_mode,nsplits", [("roll", 2), ("roll", 4),
                                               ("random", 4)])
@pytest.mark.parametrize("tuned", [False, True])
def test_k5b_rung_axis_matches_jax_get_proposal(pair_mode, nsplits, tuned):
    rng = np.random.default_rng(70 + nsplits + 2 * tuned)
    T, nw, nd = 3, 24, 5
    ng = nw // nsplits
    coords = rng.normal(size=(T, nw, nd)).astype(np.float32)
    scale = np.array([0.6, 1.0, 1.4], np.float32) if tuned else None
    jmove = JSnookerMove(gammas=1.7, pair_mode=pair_mode, nsplits=nsplits)
    jmodel = JModel(compute_log_prob=None, nwalkers=nw)
    for split in range(nsplits):
        keys = [jax.random.key(400 + 10 * r + split) for r in range(T)]
        u4 = rng.uniform(size=(T, 4)).astype(np.float32)
        u4[1, 1:] = 1.0 - 2.0**-24  # a rung's shifts at the top of range
        if pair_mode == "roll":
            inject = dict(u4=torch.from_numpy(u4))
        else:
            inject = stack([jax_random_draws(k, ng) for k in keys])
        q, f = snooker_propose_plain(
            torch.tensor(coords), split, nsplits, gammas=1.7,
            scale=None if scale is None else torch.tensor(scale),
            ndim_global=nd, pair_mode=pair_mode, **inject)
        assert q.shape == (T, ng, nd) and f.shape == (T, ng)
        for r in range(T):
            s, c_parts = rung_parts(coords, r, split, nsplits)
            kw = {} if scale is None else dict(scale=jnp.float32(scale[r]))
            if pair_mode == "roll":
                kw["extra"] = jnp.asarray(u4[r])
            jq, jf = jmove.get_proposal(keys[r], s, c_parts, jmodel, **kw)
            np.testing.assert_allclose(q[r].numpy(), np.asarray(jq),
                                       SN_RTOL, SN_ATOL)
            np.testing.assert_allclose(f[r].numpy(), np.asarray(jf), 0,
                                       SN_F_ATOL)


def de_injection(gen, T, ng, nc, pair_mode):
    z = dict(z=torch.randn(T, ng, generator=gen))
    if pair_mode == "roll":
        return dict(z, u_shift=torch.rand(T, 2, generator=gen))
    return dict(z, idx_a=torch.randint(0, nc, (T, ng), generator=gen,
                                       dtype=torch.int32),
                idx_b=torch.randint(0, nc - 1, (T, ng), generator=gen,
                                    dtype=torch.int32))


def sn_injection(gen, T, ng, pair_mode):
    if pair_mode == "roll":
        return dict(u4=torch.rand(T, 4, generator=gen))
    return dict(idx=torch.randint(0, ng, (T, 3, ng), generator=gen,
                                  dtype=torch.int32),
                perm=torch.randint(0, 6, (T, ng), generator=gen,
                                   dtype=torch.int32))


K5_CASES = [("de", "roll", 2), ("de", "random", 2), ("de", "roll", 3),
            ("de", "random", 3), ("de", "roll", 4), ("de", "random", 4),
            ("snooker", "roll", 2), ("snooker", "roll", 4),
            ("snooker", "random", 4)]


@pytest.mark.parametrize("kind,pair_mode,nsplits", K5_CASES)
@pytest.mark.parametrize("draws", ["injected", "stream", "device word"])
def test_rung_axis_plain_versions_equal_each_rung_alone(kind, pair_mode,
                                                        nsplits, draws):
    """Bit for bit (``torch.equal``): each rung of a rung-axis proposal is
    the one-ensemble plain version of that rung under ``keys.seeds[r]``,
    every split, scale per rung; the stream at a host offset and at a
    device word (on the CPU, a 0-d CPU tensor)."""
    gen = torch.Generator().manual_seed(hash((kind, pair_mode, nsplits))
                                        % 2**31)
    T, nw, nd = 4, 24, 3
    ng = nw // nsplits
    keys = rung_keys(91, T, "cpu")
    coords = torch.randn(T, nw, nd, generator=gen)
    scale = 0.5 + torch.rand(T, generator=gen)
    offset = (DeviceOffset(torch.tensor(5, dtype=torch.int64), 4)
              if draws == "device word" else 9)
    if kind == "de":
        plain = de_propose_plain
        base = dict(gamma0=de_gamma0(None, nd), sigma=0.2)
    else:
        plain = snooker_propose_plain
        base = dict(gammas=1.7, ndim_global=nd)
    for split in range(nsplits):
        inj = {}
        if draws == "injected":
            inj = (de_injection(gen, T, ng, nw - ng, pair_mode)
                   if kind == "de" else sn_injection(gen, T, ng, pair_mode))
        q, f = plain(coords, split, nsplits, pair_mode=pair_mode,
                     scale=scale, seed=keys, offset=offset, **base, **inj)
        for r in range(T):
            qr, fr = plain(coords[r], split, nsplits, pair_mode=pair_mode,
                           scale=scale[r], seed=keys.seeds[r], offset=9,
                           **base, **{k: v[r] for k, v in inj.items()})
            assert torch.equal(qr, q[r]) and torch.equal(fr, f[r]), (split,
                                                                     r)
        if draws != "injected":  # the rungs draw apart
            assert not torch.equal(q[0], q[1])


def ll_blobs(x):  # tests/unit/test_pt_parity.py:218-220
    ll = -0.5 * torch.sum((x - 1.0) ** 2)
    return ll, 2.0 * ll, x


def lp_box(x):
    return torch.where(torch.all(torch.abs(x) < 4.0), 0.0, -torch.inf)


def carries_of(s):
    return [{k: v.clone() for k, v in c.items()} if isinstance(c, dict)
            else c for c in s._move_carries]


@pytest.mark.parametrize("make,kw", [
    (lambda: moves.DEMove(), {}),
    (lambda: moves.DEMove(pair_mode="roll", randomize_split=False), {}),
    (lambda: moves.DESnookerMove(), {}),
    (lambda: moves.DESnookerMove(pair_mode="roll", nsplits=2), {}),
    (lambda: moves.DESnookerMove(tune_target=0.3), dict(tune=True)),
    (lambda: [(moves.DEMove(), 0.8), (moves.DESnookerMove(), 0.2)],
     dict(mixture_block=1)),
    (lambda: [(moves.DEMove(), 0.8), (moves.DESnookerMove(), 0.2)],
     dict(mixture_block=4)),
])
def test_batched_path_equals_the_per_rung_loop(make, kw):
    """Every rung at once (K5a / K5b and K2 with the rung axis, the
    log-prob over ``T * ng`` rows) against the forced per-rung loop, bit
    for bit: chain, logL, logP, the blobs ``(2 logL, x)``, acceptance,
    swaps, random state and the tuned carries; the box prior rejects
    some proposals, so its ``-inf`` branch runs."""
    tune = kw.pop("tune", False)
    ends = []
    for batched in (True, False):
        s = PTSampler(3, 16, 2, ll_blobs, lp_box, moves=make(), seed=11,
                      device="cpu", **kw)
        s._batched = batched
        start = np.random.default_rng(2).normal(size=(3, 16, 2))
        s.run_mcmc(start, 6, thin_by=2, tune=tune)
        s.run_mcmc(None, 4, tune=tune)
        blobs = s.get_blobs()
        ends.append((s.get_chain(), s.get_log_like(), s.get_log_prior(),
                     np.asarray(blobs[0]), np.asarray(blobs[1]),
                     s.backend.accepted, s.swaps_accepted, s.swaps_proposed,
                     s.backend.random_state, carries_of(s)))
    for x, y in zip(ends[0][:-1], ends[1][:-1]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert 0 < ends[0][5].sum() < 16 * 3 * 16
    for a, b in zip(ends[0][-1], ends[1][-1]):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            assert all(torch.equal(a[k], b[k]) for k in a)
    if tune:
        assert int(ends[0][-1][0]["t"][0]) == 16
        assert not torch.equal(ends[0][-1][0]["log_adj"],
                               torch.zeros(3))


def test_de_snooker_mixture_on_every_rung_keeps_both_modes():
    """The DE 0.8 + snooker 0.2 mixture (``benchmarks/workload3.py:71-77``)
    on every rung of test_tempering.py:273's bimodal target: the cold
    rung holds both modes."""

    def log_like(x):
        a = -0.5 * torch.sum((x - 3.0) ** 2)
        b = -0.5 * torch.sum((x + 3.0) ** 2)
        return torch.logaddexp(a, b)

    def log_prior(x):
        return -0.5 * torch.sum(x**2) / 100.0

    steps = 500
    s = PTSampler(4, 32, 1, log_like, log_prior, seed=0, device="cpu",
                  moves=[(moves.DEMove(), 0.8), (moves.DESnookerMove(), 0.2)])
    s.run_mcmc(np.random.default_rng(0).normal(size=(4, 32, 1)), steps)
    cold = s.get_chain(temp=0, flat=True, discard=steps // 5)
    frac_pos = float(np.mean(cold > 0))
    assert 0.25 < frac_pos < 0.75, frac_pos
    assert np.all(s.acceptance_fraction > 0)
    assert np.all(s.tswap_acceptance_fraction > 0)
