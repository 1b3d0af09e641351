"""K10, DE-Z's spread, proposal and archive fold
(``emcee_tpu_torch/ops/dez_kernel.py``), against the JAX package.

The plain versions are the kernels' arithmetic on the CPU:

* K10a and K10b's prologue (``dez_spread_plain``, ``spread_plain``): the
  complement's spread and its floor against ``jnp.std`` and the floor of
  ``emcee_tpu/moves/de_z.py:185-189`` at rtol = atol = 1e-5, a complement
  at mean 1e4 and a column constant across it (the floor binds) among
  them; the bits do not depend on the runs a block merges; the kernel's
  stack merge, replayed in numpy float32, gives the tree's bits.
* K10b (``dez_propose_plain``) against ``DEZMove.get_proposal`` under
  JAX's own draws, reproduced from the same key and injected, on every
  branch (``g1_prob`` 0 / 1, ``snooker_prob`` 0 / 1 / 0.1, ``de_noise`` 0 /
  > 0, the archive empty, partly filled and full), at the 1e-5 of
  ``tests/test_torch_de_z.py``.
* K10c (``dez_fold_plain``) bit for bit against JAX's ``update_carry``
  over enough calls to wrap the ring, one ensemble and three rungs.
* The rung axis of each plain version bit for bit against each rung alone
  under its own key, and ``dez_plan`` over edge shapes.

JAX runs on the CPU (tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu import moves as jmoves
from emcee_tpu.state import State as JState

from emcee_tpu_torch.ops import dez_kernel as dk
from emcee_tpu_torch.ops.de_kernel import de_gamma0
from emcee_tpu_torch.ops.philox import DeviceOffset, rung_keys
from tests.test_torch_de_z import jax_dez_draws, jmodel

RTOL = ATOL = 1e-5


def floor_spread_jax(c):
    """``emcee_tpu/moves/de_z.py:185-189`` on the complement ``c``."""
    spread = jnp.std(jnp.asarray(c), axis=0)
    return np.asarray(jnp.maximum(spread, 0.01 * jnp.mean(spread) + 1e-12))


def rows(seed, n, nd, mean=0.0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (mean + scale * rng.normal(size=(n, nd))).astype(np.float32)


@pytest.mark.parametrize("n,nd,mean,lo", [
    (40, 3, 0.0, 20), (1001, 5, 0.0, 0), (3000, 2, 1e4, 1500),
    (129, 1, -3.0, 64), (2600, 9, 1e4, 0)])
def test_spread_matches_jnp_std_and_its_floor(n, nd, mean, lo):
    x = rows(n + nd, n, nd, mean, 3.0)
    ng = n // 2 if lo else n // 3
    c = np.concatenate([x[:lo], x[lo + ng:]])
    part = dk.dez_spread_plain(torch.from_numpy(x), (lo, ng))
    got = dk.spread_plain(part).numpy()
    np.testing.assert_allclose(got, floor_spread_jax(c), RTOL, ATOL)


def test_the_floor_binds_on_a_constant_column():
    x = rows(3, 300, 4, 1e4)
    x[:, 2] = np.float32(7.25)
    c = x[100:]
    got = dk.spread_plain(dk.dez_spread_plain(torch.from_numpy(x),
                                              (0, 100))).numpy()
    want = floor_spread_jax(c)
    assert got[2] > 0 and got[2] == got[2]
    np.testing.assert_allclose(got, want, RTOL, ATOL)
    # The floor is 0.01 of the mean spread (plus 1e-12).
    spread = c.astype(np.float64).std(0)
    np.testing.assert_allclose(got[2], 0.01 * spread.mean(), 1e-5)


@pytest.mark.parametrize("rows_,n", [(128, 5000), (128, 129), (16, 333),
                                     (7, 1000)])
def test_spread_bits_do_not_depend_on_the_group(rows_, n):
    x = torch.from_numpy(rows(n, n, 3, 1e4))
    got = [dk.spread_plain(dk.dez_spread_plain(x, (10, 20), rows=rows_,
                                               group=g))
           for g in (1, 2, 4, 8)]
    for g in got[1:]:
        assert torch.equal(g, got[0])


def _chan(a, b):
    """One column's Chan combine in numpy float32, as csrc/dez_propose.cu
    ``chan`` computes it."""
    f = np.float32
    (na, ma, qa), (nb, mb, qb) = a, b
    if nb == 0:
        return a
    if na == 0:
        return b
    n = f(na + nb)
    d = f(mb - ma)
    coef = f(f(na * nb) / n)
    return n, f(ma + f(d * f(nb / n))), f(f(qa + qb) + f(coef * f(d * d)))


def _stack_tree(nodes):
    """K10b's prologue merge: a stack that merges two subtrees of one
    level, then folds from its top."""
    stack = []
    for node in nodes:
        level = 0
        while stack and stack[-1][1] == level:
            node = _chan(stack.pop()[0], node)
            level += 1
        stack.append((node, level))
    node = stack[-1][0]
    for prev, _ in reversed(stack[:-1]):
        node = _chan(prev, node)
    return node


@pytest.mark.parametrize("n", [1, 7, 100, 1000, 4097, 9001])
def test_the_kernels_stack_merge_is_the_trees_bits(n):
    x = torch.from_numpy(rows(n, n, 2, 50.0))
    part = dk.dez_spread_plain(x, (0, 0), rows=8, group=1)
    nd = 2
    top = dk._merge_levels(part, float("inf"))[0]
    p = part.numpy()
    for c in range(nd):
        node = _stack_tree([(p[k, 0], p[k, 1 + c], p[k, 1 + nd + c])
                            for k in range(p.shape[0])])
        assert node[0] == top[0].item()
        assert node[1] == top[1 + c].item() and node[2] == top[
            1 + nd + c].item()


def jax_proposal(x, split, ns, carry, kw, key):
    """JAX's ``get_proposal`` of group ``split`` and its draws, injected."""
    nw, nd = x.shape
    ng = nw // ns
    jmove = jmoves.DEZMove(**kw)
    bl = [x[j * ng:(j + 1) * ng] for j in range(ns)]
    jcarry = {k: jnp.asarray(v.numpy()) for k, v in carry.items()}
    jq, jf = jmove.get_proposal(key, jnp.asarray(bl[split]),
                                tuple(jnp.asarray(b) for j, b in
                                      enumerate(bl) if j != split),
                                jmodel(nw, nd), carry=jcarry)
    draws = jax_dez_draws(key, ng, nd, nw - ng + int(carry["filled"]),
                          jmove.g1_prob, jmove.snooker_prob)
    return np.asarray(jq), np.asarray(jf), draws


def cfg_of(nd, **kw):
    mv = dict(sigma=1e-5, g1_prob=0.1, snooker_prob=0.1, gammas=1.7,
              de_noise=1e-2) | kw
    return dk.DezConfig(de_gamma0(None, nd), mv["sigma"], mv["g1_prob"],
                        mv["snooker_prob"], mv["gammas"], mv["de_noise"],
                        nd - 1.0)


def ring(nd, k, filled, seed, mean=0.0):
    rng = np.random.default_rng(seed)
    z = np.zeros((k, nd), np.float32)
    z[:filled] = mean + rng.normal(size=(filled, nd))
    return {"z": torch.from_numpy(z),
            "filled": torch.tensor(filled, dtype=torch.int32),
            "ptr": torch.tensor(filled % k, dtype=torch.int32),
            "t": torch.tensor(0, dtype=torch.int32)}


@pytest.mark.parametrize("g1", [0.0, 1.0])
@pytest.mark.parametrize("snooker", [0.0, 1.0, 0.1])
@pytest.mark.parametrize("noise", [0.0, 0.05])
@pytest.mark.parametrize("filled", [0, 23, 64])
def test_k10b_matches_jax_get_proposal_on_every_branch(g1, snooker, noise,
                                                        filled):
    nw, nd, ns, k = 40, 3, 2, 64
    split = (filled // 23) % ns
    kw = dict(g1_prob=g1, snooker_prob=snooker, de_noise=noise,
              archive_size=k, update_rows=8)
    x = rows(filled + 7, nw, nd)
    carry = ring(nd, k, filled, filled)
    key = jax.random.key(17 + filled)
    jq, jf, draws = jax_proposal(x, split, ns, carry, kw, key)
    xt = torch.from_numpy(x)
    ng = nw // ns
    part = (dk.dez_spread_plain(xt, (split * ng, ng)) if noise > 0
            else None)
    q, f = dk.dez_propose_plain(xt, split, ns, carry["z"], carry["filled"],
                                part, 1, 2, cfg_of(nd, **{
                                    k_: kw[k_] for k_ in (
                                        "g1_prob", "snooker_prob",
                                        "de_noise")}), extra=draws)
    np.testing.assert_allclose(q.numpy(), jq, RTOL, ATOL)
    np.testing.assert_allclose(f.numpy(), jf, RTOL, ATOL)


def test_k10b_at_mean_1e4_with_three_splits():
    nw, nd, ns, k = 60, 4, 3, 128
    x = rows(5, nw, nd, 1e4)
    carry = ring(nd, k, 77, 6, 1e4)
    kw = dict(g1_prob=0.3, snooker_prob=0.4, de_noise=0.2, archive_size=k)
    for split in range(ns):
        key = jax.random.key(40 + split)
        jq, jf, draws = jax_proposal(x, split, ns, carry, kw, key)
        xt = torch.from_numpy(x)
        part = dk.dez_spread_plain(xt, (split * 20, 20))
        q, f = dk.dez_propose_plain(xt, split, ns, carry["z"],
                                    carry["filled"], part, 1, 2,
                                    cfg_of(nd, g1_prob=0.3, snooker_prob=0.4,
                                           de_noise=0.2), extra=draws)
        np.testing.assert_allclose(q.numpy(), jq, RTOL, ATOL)
        np.testing.assert_allclose(f.numpy(), jf, RTOL, 1e-4)


def test_k10b_draws_from_the_stream_stay_in_the_pool():
    """Without injection the picks fall in ``[0, n_avail)`` and ``j``
    differs from ``i``: with every pool row of the archive a distinct
    constant, a walker's DE difference is one of the pairs'."""
    nw, nd, k = 16, 2, 32
    x = torch.from_numpy(rows(1, nw, nd))
    carry = ring(nd, k, 5, 2)
    cfg = cfg_of(nd, g1_prob=1.0, snooker_prob=0.0, de_noise=0.0)
    for offset in range(20):
        q, f = dk.dez_propose_plain(x, 0, 2, carry["z"], carry["filled"],
                                    None, 9, offset, cfg)
        assert torch.all(f == 0)
        pool = torch.cat([x[8:], carry["z"][:5]])
        diffs = pool[:, None, :] - pool[None, :, :]
        d = (q - x[:8])[:, None, None, :]
        hit = torch.isclose(d, diffs[None], atol=1e-6).all(-1)
        off_diag = ~torch.eye(13, dtype=torch.bool)
        assert torch.all((hit & off_diag).any(-1).any(-1))


@pytest.mark.parametrize("archive_size,update_rows", [
    (100, 24), (32, 8), (45, 7), (64, 64)])
def test_k10c_matches_jax_update_carry_bit_for_bit(archive_size,
                                                   update_rows):
    nw, nd = 40, 3
    jmove = jmoves.DEZMove(archive_size=archive_size,
                           update_rows=update_rows)
    jcarry = jmove.init_carry(nw, nd)
    k = jcarry["z"].shape[0]
    carry = {kk: torch.from_numpy(np.array(v)) for kk, v in jcarry.items()}
    nrows = min(update_rows, nw)
    rng = np.random.default_rng(archive_size)
    for _ in range(2 * k // nrows + 3):  # the ring wraps at least twice
        x = rng.normal(size=(nw, nd)).astype(np.float32)
        jcarry = jmove.update_carry(jcarry, JState(jnp.asarray(x)),
                                    jmodel(nw, nd))
        dk.dez_fold_plain(torch.from_numpy(x), carry["z"], carry["filled"],
                          carry["ptr"], carry["t"], nrows)
        for key, v in jcarry.items():
            v = np.asarray(v)
            got = carry[key].numpy()
            assert got.dtype == v.dtype and np.array_equal(got, v), key
    assert int(carry["filled"]) == k


def test_k10c_rung_axis_equals_each_rung_alone():
    T, nw, nd, k, nrows = 3, 24, 2, 40, 7
    rng = np.random.default_rng(8)
    z = torch.from_numpy(rng.normal(size=(T, k, nd)).astype(np.float32))
    words = [torch.tensor(v, dtype=torch.int32) for v in (
        [3, 40, 17], [3, 0, 17], [5, 11, 1000])]
    alone = [(z[r].clone(), *(w[r].clone() for w in words))
             for r in range(T)]
    for _ in range(9):
        x = torch.from_numpy(rng.normal(size=(T, nw, nd)).astype(np.float32))
        dk.dez_fold_plain(x, z, *words, nrows)
        for r in range(T):
            dk.dez_fold_plain(x[r], *alone[r], nrows)
    for r in range(T):
        assert torch.equal(z[r], alone[r][0])
        for w, a in zip(words, alone[r][1:]):
            assert torch.equal(w[r], a)


@pytest.mark.parametrize("cfg_kw", [
    {}, {"g1_prob": 0.5, "snooker_prob": 0.5, "de_noise": 0.3},
    {"g1_prob": 0.0, "snooker_prob": 0.0, "de_noise": 0.0}])
@pytest.mark.parametrize("split", [0, 1])
def test_rung_axis_plain_versions_equal_each_rung_alone(cfg_kw, split):
    T, nw, nd, k, ns = 3, 32, 3, 64, 2
    rng = np.random.default_rng(split)
    x = torch.from_numpy((rng.normal(size=(T, nw, nd)) * [[[1.0]], [[3.0]],
                                                          [[0.5]]])
                         .astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(T, k, nd)).astype(np.float32))
    filled = torch.tensor([0, 30, 64], dtype=torch.int32)
    cfg = cfg_of(nd, **cfg_kw)
    keys = rung_keys(21, T, "cpu")
    ng = nw // ns
    part = dk.dez_spread_plain(x, (split * ng, ng))
    word = torch.tensor(3, dtype=torch.int64)
    q, f = dk.dez_propose_plain(x, split, ns, z, filled, part, keys,
                                DeviceOffset(word, 2), cfg)
    for r in range(T):
        pr = dk.dez_spread_plain(x[r], (split * ng, ng))
        assert torch.equal(pr, part[r])
        qr, fr = dk.dez_propose_plain(x[r], split, ns, z[r], filled[r], pr,
                                      keys.seeds[r], 5, cfg)
        assert torch.equal(qr, q[r]) and torch.equal(fr, f[r])


def test_wrappers_run_the_plain_versions_on_the_cpu():
    nw, nd = 16, 2
    x = torch.from_numpy(rows(0, nw, nd))
    carry = ring(nd, 32, 9, 1)
    cfg = cfg_of(nd)
    before = (dk.dez_spread.launches, dk.dez_propose.launches,
              dk.dez_fold.launches)
    part = dk.dez_spread(x, (0, 8))
    assert torch.equal(part, dk.dez_spread_plain(x, (0, 8)))
    got = dk.dez_propose(x, 0, 2, carry["z"], carry["filled"], part, 4, 6,
                         cfg)
    want = dk.dez_propose_plain(x, 0, 2, carry["z"], carry["filled"], part,
                                4, 6, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    dk.dez_fold(x, carry["z"], carry["filled"], carry["ptr"], carry["t"], 8)
    assert int(carry["t"]) == 1 and int(carry["filled"]) == 17
    assert (dk.dez_spread.launches, dk.dez_propose.launches,
            dk.dez_fold.launches) == before
    meta = torch.empty(nw, nd, device="meta")
    with pytest.raises(ValueError, match="no K10a kernel"):
        dk.dez_spread(meta, (0, 8))
    with pytest.raises(ValueError, match="no K10b kernel"):
        dk.dez_propose(meta, 0, 2, carry["z"], carry["filled"], None, 1, 0,
                       cfg)
    with pytest.raises(ValueError, match="no K10c kernel"):
        dk.dez_fold(meta, carry["z"], carry["filled"], carry["ptr"],
                    carry["t"], 8)


@pytest.mark.parametrize("n,nd", [(1, 1), (37, 1), (5003, 5), (50000, 5),
                                  (150000, 5), (5000, 8), (777, 9),
                                  (5003, 80), (50000, 100), (150000, 129),
                                  (20, 4096)])
def test_dez_plan_over_edge_shapes(n, nd):
    plan = dk.dez_plan(n, nd)
    assert plan.rows == dk.DEZ_ROWS and plan.group in (1, 2, 4, 8)
    span = plan.rows * plan.group
    assert (plan.blocks - 1) * span < n <= plan.blocks * span
    if plan.staged:
        # the widest group whose rows fit the staging budget
        assert dk._staged_bytes(plan.rows, plan.group, nd) <= dk.DEZ_SMEM
        assert plan.group == 8 or dk._staged_bytes(
            plan.rows, 2 * plan.group, nd) > dk.DEZ_SMEM
    else:
        assert plan.group == 8
        assert dk._staged_bytes(plan.rows, 1, nd) > dk.DEZ_SMEM
    smem = dk.spread_smem(plan, nd)
    assert smem == 4 * (plan.staged * plan.group * (plan.rows * nd + 1)
                        + plan.group * (1 + 2 * nd))
    assert smem <= 48 * 1024 or nd > 3000
    for g in (1, 2, 4, 8):
        forced = dk.dez_plan(n, nd, group=g)
        assert forced.group == g
        assert forced.blocks == -(-n // (plan.rows * g))
    with pytest.raises(ValueError):
        dk.dez_plan(n, nd, group=3)
    with pytest.raises(ValueError):
        dk.dez_plan(n, nd, rows=0)
