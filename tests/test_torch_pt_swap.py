"""K15, the even/odd swap of a tempered ladder, and the rungs' streams.

``pt_swap_plain`` against the JAX package's ``PTSampler._swap_step`` under
the same uniforms (``jax.random.uniform`` of the step's key, injected as
``u``), for 2-5 rungs and both parities: the exchanged coords, logL and
logP must be equal (the decision is one float32 compare of the same
operations on both sides), and the accepted counts too.  Then the
port-only parts: the tempered log-prob formed anew on the new rung, the
steps that do not swap, the swap's own Philox counters, and the rung
keys (``ops/philox.py``) against the counter layout they promise.
JAX runs on the CPU (tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu.parallel.tempering import PTSampler as JPTSampler

from emcee_tpu_torch.ops import philox, swap_kernel
from emcee_tpu_torch.ops.swap_kernel import (
    pt_swap, pt_swap_plain, swap_pairs, tempered_log_prob)

NW, ND = 24, 3


def ladder_data(T, seed=0, specials=False):
    """Numpy coords, logL, logP and a ladder of ``T`` rungs."""
    rng = np.random.default_rng(seed)
    coords = rng.normal(size=(T, NW, ND)).astype(np.float32)
    ll = (3.0 * rng.normal(size=(T, NW))).astype(np.float32)
    lpr = np.zeros((T, NW), np.float32)
    if specials:
        ll[:, ::7] = np.nan
        ll[:, 1::11] = np.inf
        ll[:, 2::13] = -np.inf
        lpr[:, 3::5] = -np.inf
    betas = (0.6 ** np.arange(T)).astype(np.float32)
    return coords, ll, lpr, betas


def torch_buffers(coords, ll, lpr, betas):
    c, l, p, b = (torch.tensor(x) for x in (coords, ll, lpr, betas))
    return c, l, p, tempered_log_prob(b[:, None], l, p), b


def jax_sampler(T, betas):
    return JPTSampler(T, NW, ND, lambda x: -0.5 * jnp.sum(x**2),
                      lambda x: 0.0, betas=betas)


@pytest.mark.parametrize("T", [2, 3, 4, 5])
@pytest.mark.parametrize("parity", [0, 1])
def test_plain_swap_matches_jax_swap_step(T, parity):
    """Exact: the same uniforms give the same exchanges and counts
    (tolerance 0: exchanged values are copies)."""
    coords, ll, lpr, betas = ladder_data(T, seed=T + 10 * parity)
    jpt = jax_sampler(T, betas)
    key = jax.random.key(100 + T)
    (jc, jl, jp, _), jacc, lo = jpt._swap_step(
        key, (jnp.asarray(coords), jnp.asarray(ll), jnp.asarray(lpr), None),
        jnp.asarray(betas), parity)
    u = np.asarray(jax.random.uniform(key, (len(lo), NW)))
    c, l, p, lp, b = torch_buffers(coords, ll, lpr, betas)
    counts = torch.zeros(T - 1, dtype=torch.int64)
    pt_swap_plain(c, l, p, lp, b, counts, offset=parity, u=torch.tensor(u))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    want = np.zeros(T - 1, np.int64)
    want[np.asarray(lo)] = np.asarray(jacc).sum(axis=1)
    np.testing.assert_array_equal(counts.numpy(), want)
    # The JAX sampler's own scatter of the counts (T rows, the last one
    # padding) agrees too.
    np.testing.assert_array_equal(
        np.asarray(jpt._scatter_swap_counts(jacc, parity))[:T - 1].sum(1),
        want)


@pytest.mark.parametrize("T", [2, 5])
def test_swap_forms_the_new_rungs_tempered_log_prob(T):
    """After a swap every rung's log-prob is ``beta logL + logP`` of its
    walkers (``-inf`` where ``logP`` is ``-inf``), as the JAX move
    recomputes it (``tempering.py:480-482``), and unaccepted walkers keep
    theirs; NaN and +-inf logL reject or accept as JAX's compare does."""
    coords, ll, lpr, betas = ladder_data(T, seed=3, specials=True)
    c, l, p, lp, b = torch_buffers(coords, ll, lpr, betas)
    counts = torch.zeros(T - 1, dtype=torch.int64)
    for step in range(4):
        pt_swap(c, l, p, lp, b, counts, seed=9, offset=step)
        want = tempered_log_prob(b[:, None], l, p)
        assert torch.equal(torch.isnan(lp), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(lp), torch.nan_to_num(want))
    assert int(counts.sum()) > 0
    # Rows are permutations of the start: every walker's (coords, logL,
    # logP) triple is still somewhere in its column.
    for w in range(NW):
        start = sorted(map(tuple, coords[:, w].tolist()))
        assert sorted(map(tuple, c[:, w].tolist())) == start


def test_swap_every_and_parity_follow_the_step():
    T = 5
    assert list(swap_pairs(0, T, 1)) == [0, 2]
    assert list(swap_pairs(7, T, 1)) == [1, 3]
    assert list(swap_pairs(1, T, 3)) == []
    assert list(swap_pairs(2, T, 3)) == [0, 2]
    assert list(swap_pairs(5, T, 3)) == [1, 3]
    assert list(swap_pairs(5, T, 0)) == []
    coords, ll, lpr, betas = ladder_data(T, seed=4)
    c, l, p, lp, b = torch_buffers(coords, ll, lpr, betas)
    counts = torch.zeros(T - 1, dtype=torch.int64)
    for step in (0, 1, 3, 4):  # not a swap step at swap_every=3
        pt_swap(c, l, p, lp, b, counts, seed=1, offset=step, swap_every=3)
    assert torch.equal(c, torch.tensor(coords)) and int(counts.sum()) == 0
    # A device offset word reads the same step.
    word = torch.tensor(3, dtype=torch.int64)
    pt_swap(c, l, p, lp, b, counts, seed=1,
            offset=philox.DeviceOffset(word, 2), swap_every=3)
    c2, l2, p2, lp2, b2 = torch_buffers(coords, ll, lpr, betas)
    counts2 = torch.zeros(T - 1, dtype=torch.int64)
    pt_swap(c2, l2, p2, lp2, b2, counts2, seed=1, offset=5, swap_every=3)
    assert torch.equal(c, c2) and torch.equal(counts, counts2)
    assert int(counts[0]) == 0 and int(counts[1]) > 0


def test_swap_draws_its_uniforms_at_swap_block():
    """The in-stream draw of walker ``w`` and pair ``lo`` is word 0 of
    counter ``(w, SWAP_BLOCK | lo, step)`` under the chain's seed (the
    scalar Philox reference), and a RungKeys seed means its rung 0."""
    T, step, seed = 4, 6, 12345
    coords, ll, lpr, betas = ladder_data(T, seed=5)
    pairs = list(swap_pairs(step, T, 1))
    u = np.array([[(philox.philox4x32_scalar(
        (w, philox.SWAP_BLOCK | lo, step, 0), philox.split_key(seed))[0]
        >> 8) * 2.0**-24 for w in range(NW)] for lo in pairs], np.float32)
    outs = []
    for kw in (dict(u=torch.tensor(u)), dict(seed=seed),
               dict(seed=philox.rung_keys(seed, T, "cpu"))):
        c, l, p, lp, b = torch_buffers(coords, ll, lpr, betas)
        counts = torch.zeros(T - 1, dtype=torch.int64)
        pt_swap_plain(c, l, p, lp, b, counts, offset=step, **kw)
        outs.append((c, l, p, lp, counts))
    for other in outs[1:]:
        for a, b_ in zip(outs[0], other):
            assert torch.equal(a, b_)


def test_wrapper_takes_the_plain_version_on_cpu_only():
    coords, ll, lpr, betas = ladder_data(3, seed=6)
    c, l, p, lp, b = torch_buffers(coords, ll, lpr, betas)
    before = pt_swap.launches
    pt_swap(c, l, p, lp, b, torch.zeros(2, dtype=torch.int64), offset=0)
    assert pt_swap.launches == before
    with pytest.raises(ValueError, match="no K15 kernel"):
        pt_swap(c.to("meta"), l.to("meta"), p.to("meta"), lp.to("meta"),
                b.to("meta"), torch.zeros(2, dtype=torch.int64,
                                          device="meta"))


def test_rung_seeds_follow_the_documented_layout():
    """Rung 0's key is the seed; rung r's is words 0 and 1 of the seed's
    counter (r, RUNG_BLOCK | 0xFFFFF, 2**32-1, 2**32-1); all distinct."""
    seed = 987654321987
    keys = [philox.rung_seed(seed, r) for r in range(16)]
    assert keys[0] == seed
    w = philox.philox4x32_scalar(
        (3, philox.RUNG_BLOCK | 0xFFFFF, philox.MASK32, philox.MASK32),
        philox.split_key(seed))
    assert keys[3] == w[0] | (w[1] << 32)
    assert len(set(keys)) == 16
    rk = philox.rung_keys(seed, 16, "cpu")
    assert rk.seeds == tuple(keys) and rk.seed == seed
    assert [int(k) & 0xFFFFFFFFFFFFFFFF for k in rk.table] == keys


@pytest.mark.parametrize("split", [0, 2, philox.PAIR_BLOCK | 1])
def test_rung_words_equal_each_rungs_walker_words(split):
    rk = philox.rung_keys(77, 5, "cpu")
    got = philox.rung_words(rk, 11, split, 13, "cpu")
    for r, s in enumerate(rk.seeds):
        want = philox.walker_words(11, split, s, 13, "cpu")
        for a, b in zip(got, want):
            assert torch.equal(a[r], b)


def test_swap_and_rung_blocks_are_apart_from_every_other_block():
    """SWAP_BLOCK and RUNG_BLOCK are EXT_BLOCK sub-blocks that no other
    block's split words reach (each block: its bits and an index below
    its bound)."""
    blocks = {  # name: (first split word, number of split words)
        "splits": (0, 1 << 20), "PAIR": (philox.PAIR_BLOCK, 1 << 20),
        "NORMAL": (philox.NORMAL_BLOCK, 1 << 20),
        "PICK": (philox.PICK_BLOCK, 1 << 20),
        "SUBSAMPLE": (philox.SUBSAMPLE_BLOCK, 1 << 20),
        "BLEND": (philox.BLEND_BLOCK, 1 << 20),
        "DEZ": (philox.DEZ_BLOCK, 1 << 20),
        "DIME": (philox.DIME_BLOCK, 1 << 20),
        "CHI2": (philox.CHI2_BLOCK, 1 << 20),
        "SLICE": (philox.SLICE_BLOCK, 1 << 20),
        "GRAD": (philox.GRAD_BLOCK, 1 << 20),
        "SHRINK": (philox.SHRINK_BLOCK, philox.SHRINK_MAX),
        "RUNG": (philox.RUNG_BLOCK, 1 << 20),
        "SWAP": (philox.SWAP_BLOCK, 1 << 20),
    }
    spans = sorted(blocks.values())
    for (a, n), (b, _) in zip(spans, spans[1:]):
        assert a + n <= b, (hex(a), n, hex(b))
    assert swap_kernel.SWAP_BLOCK == 0x08700000  # EMCEE_SWAP_BLOCK in K15


def test_tempered_log_prob_order_and_mask():
    beta = torch.tensor([0.3, 1.0])[:, None]
    ll = torch.tensor([[1.1, -2.0, 5.0], [0.7, 3.0, float("nan")]])
    lpr = torch.tensor([[0.2, -float("inf"), float("nan")],
                        [-0.5, 0.0, 1.0]])
    got = tempered_log_prob(beta, ll, lpr)
    want = beta * ll + lpr
    assert got[0, 0] == want[0, 0] and got[1, 0] == want[1, 0]
    assert got[0, 1] == -float("inf") and got[0, 2] == -float("inf")
    assert torch.isnan(got[1, 2])


def _leaf(shape, dtype, misalign=0):
    """A zero CPU tensor of ``shape`` whose base lies ``misalign`` bytes
    past a 16-byte boundary."""
    item = torch.empty(0, dtype=dtype).element_size()
    n = int(np.prod(shape)) * item
    store = torch.zeros(n + 32, dtype=torch.uint8)
    skip = (-store.data_ptr() + misalign) % 16
    return store[skip:skip + n].view(dtype).view(shape)


@pytest.mark.parametrize("specs,n_reg,unit,order", [
    ((("float32", (), 0), ("float32", (5,), 0)), 1, 4, (0, 1)),
    ((("float32", (5,), 0), ("float32", (), 0)), 1, 4, (1, 0)),
    ((("int32", (), 4),) * 5, 4, 4, (0, 1, 2, 3, 4)),
    ((("float64", (), 0), ("int64", (), 8)), 2, 8, (0, 1)),
    ((("float64", (), 0), ("float32", (), 4)), 1, 4, (1, 0)),
    ((("int16", (2,), 2),), 0, 0, (0,)),
    ((("int8", (3,), 0), ("int32", (2,), 4)), 0, 0, (0, 1)),
])
def test_leaf_plan_takes_scalar_leaves_through_registers(specs, n_reg, unit,
                                                         order):
    """K15's leaf plan: up to four leaves whose rows are one 4-byte unit
    (else one 8-byte unit) go first, through registers; every other leaf
    (a wider row, a base that splits the unit, the fifth scalar) follows
    in its own order, through the table."""
    T, nw = 3, 8
    leaves = [_leaf((T, nw) + row, getattr(torch, dt), mis)
              for dt, row, mis in specs]
    table = swap_kernel.swap_leaves(leaves, T, nw, torch.device("cpu"))
    plan, plan_order = swap_kernel.swap_plan(nw, T, 132, table)
    assert plan_order == [table[i] for i in order]
    assert (plan.n_reg, plan.reg_unit) == (n_reg, unit)


@pytest.mark.parametrize("nw,T,n_sm,threads", [
    (256, 16, 132, 32), (2000, 16, 132, 64), (100_000, 16, 132, 128),
    (256, 2, 1, 128), (8, 3, 132, 32)])
def test_swap_plan_sizes_the_block_for_latency(nw, T, n_sm, threads):
    """The largest block of 128, 64, 32 threads whose grid has a block for
    every SM, else 32 (workload 4's 16 x 256: 64 blocks of 32)."""
    plan, order = swap_kernel.swap_plan(nw, T, n_sm)
    assert plan.threads == threads and plan.threads % 32 == 0
    assert order == []
    assert (plan.n_reg, plan.reg_unit) == (0, 0)


def test_leaf_plan_refusals():
    T, nw, cpu = 2, 4, torch.device("cpu")
    wide = [_leaf((T, nw, 5), torch.float32) for _ in range(17)]
    with pytest.raises(ValueError, match="at most 16 blob leaves"):
        swap_kernel.swap_leaves(wide, T, nw, cpu)
    # Four scalars ride in registers beside sixteen table leaves.
    scalars = [_leaf((T, nw), torch.float32) for _ in range(4)]
    table = swap_kernel.swap_leaves(scalars + wide[:16], T, nw, cpu)
    assert swap_kernel.swap_plan(nw, T, 1, table)[0][1:] == (4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        swap_kernel.swap_leaves([_leaf((T, nw + 1), torch.float32)], T, nw,
                                cpu)
    with pytest.raises(ValueError, match="contiguous"):
        swap_kernel.swap_leaves([_leaf((T, nw, 2), torch.float32)[..., 0]],
                                T, nw, cpu)
    with pytest.raises(ValueError, match="contiguous"):
        swap_kernel.swap_leaves([torch.zeros(T, nw, device="meta")], T, nw,
                                cpu)
