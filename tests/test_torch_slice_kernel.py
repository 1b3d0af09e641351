"""K9, the slice move's loops (``emcee_tpu_torch/ops/slice_kernel.py``),
against the JAX package and against a walker-by-walker replay.

* The plain route (``EnsembleSliceMove`` on the CPU: K9a-K9d's plain
  versions on compacted lists) against JAX's ``EnsembleSliceMove._inner``
  under JAX's own draws, reproduced in the test (``jax.random.split(k,
  5)``, the ``randint`` picks and budget, the window's ``uniform`` and the
  shrink loop's key chain for ``max_shrink`` trips) and injected, split
  after split of the blocked engine: ndim 1, 3 and 5, odd groups, blobs
  and none, binding caps, a tuned scale.  The coordinates and log-probs
  agree within float32 rounding (rtol = atol = 1e-5: XLA may contract a
  product and a sum into one rounding where the port rounds twice), the
  acceptance and the expansion and contraction counts exactly.
* The compacted route against the masked loops, bit for bit: a numpy
  float32 replay of Neal's loops walker by walker, on the port's Philox
  draws, with a log-prob summed column by column in both.
* The stable compaction's order against ``torch.nonzero``, and the bucket
  rule at its edges (a length of 0, 1, a power of two, ``2 ng``).
* The rung axis: every rung of ``propose_rungs`` against that rung alone
  under its own key, bit for bit.

JAX runs on the CPU (tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu import moves as jmoves
from emcee_tpu.model import Model as JModel

from emcee_tpu_torch import moves
from emcee_tpu_torch.chunk_graph import EagerLoops, bucket_of, buckets
from emcee_tpu_torch.model import Model, wrap_log_prob_fn
from emcee_tpu_torch.ops import slice_kernel as sk
from emcee_tpu_torch.ops.philox import (
    SHRINK_BLOCK, SLICE_BLOCK, philox4x32_scalar, rung_keys, split_key,
    uniforms_scalar)
from emcee_tpu_torch.state import State

RTOL = ATOL = 1e-5


def lp_rows(x):
    """``-0.5 |x|^2`` summed column by column (the same roundings in torch
    and numpy)."""
    acc = x[..., 0] * x[..., 0]
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., c] * x[..., c]
    return -0.5 * acc


def lp_blobs(x):
    lp = lp_rows(x)
    return lp, (2.0 * lp, x[..., 0])


def j_lp_blobs(x):
    lp = -0.5 * jnp.sum(x * x, axis=-1)
    return lp, (2.0 * lp, x[..., 0])


def start(nw, nd, seed, blobs):
    x = np.random.default_rng(seed).normal(size=(nw, nd)).astype(np.float32)
    xt = torch.from_numpy(x.copy())
    lp, bl = (lp_blobs if blobs else (lambda q: (lp_rows(q), None)))(xt)
    # The blob x[..., 0] is a view of the rows: the state keeps a copy.
    return x, State(xt, lp, None if bl is None else tuple(
        b.clone() for b in bl))


def jax_draws(k, ng, nc, max_steps, max_shrink):
    """JAX's draws of one ``_inner`` call (``emcee_tpu/moves/slice.py:
    174-180, 252-254``) as the port's injected draws."""
    k_i, k_j, k_off, k_budget, k_shrink = jax.random.split(k, 5)
    d = {"i": jax.random.randint(k_i, (ng,), 0, nc),
         "j": jax.random.randint(k_j, (ng,), 0, nc - 1),
         "u": jax.random.uniform(k_off, (ng,), dtype=jnp.float32),
         "j_l": jax.random.randint(k_budget, (ng,), 0, max_steps)}
    key, cols = k_shrink, []
    for _ in range(max_shrink):
        key, sub = jax.random.split(key)
        cols.append(jax.random.uniform(sub, (ng,), dtype=jnp.float32))
    d = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in d.items()}
    d["shrink_u"] = torch.from_numpy(np.stack(
        [np.asarray(c) for c in cols], -1).copy())
    return d


@pytest.mark.parametrize("nd,ng,blobs,kw,tuned", [
    (1, 9, False, {}, False),
    (3, 21, True, {}, False),
    (5, 15, False, dict(mu=20.0, max_steps=3, max_shrink=2), False),
    (3, 11, True, dict(max_steps=2), True),
    (5, 33, True, dict(mu=0.3, max_shrink=40), True),
])
def test_plain_route_matches_jax_inner_under_jax_draws(nd, ng, blobs, kw,
                                                        tuned):
    nw, ns = 2 * ng, 2
    mv = moves.EnsembleSliceMove(randomize_split=False, tune_mu=tuned, **kw)
    jmv = jmoves.EnsembleSliceMove(randomize_split=False, tune_mu=tuned, **kw)
    x, st = start(nw, nd, nd + ng, blobs)
    carry = mv.init_carry(nw, nd, device="cpu")
    scale = None
    if tuned:
        carry["log_adj"].fill_(0.4)
        scale = jnp.exp(jnp.float32(0.4))
    keys = jax.random.split(jax.random.key(ng + nd), ns)
    log_u = np.log(np.random.default_rng(ng).uniform(
        size=(ns, ng))).astype(np.float32)
    draws = [jax_draws(k, ng, nw - ng, mv.max_steps, mv.max_shrink)
             for k in keys]
    count = torch.zeros(nw, dtype=torch.int32)
    model = Model(wrap_log_prob_fn(lp_blobs if blobs else lp_rows,
                                   vectorize=True), nw, nd)
    st, acc, carry = mv.propose((3, 0), st, model, carry, count,
                                log_acc_u=torch.from_numpy(log_u),
                                draws=draws)
    # JAX's blocked engine, split after split (red_blue.py:277-340).
    jm = JModel(j_lp_blobs if blobs else
                (lambda q: (-0.5 * jnp.sum(q * q, axis=-1), None)),
                nwalkers=nw, ndim=nd)
    coords = jnp.asarray(x)
    lp, bl = jm.compute_log_prob(coords)
    jacc, stats = [], []
    for split in range(ns):
        lo = split * ng
        blk = slice(lo, lo + ng)
        c_parts = tuple(coords[j * ng:(j + 1) * ng] for j in range(ns)
                        if j != split)
        q, lq, bq, done, st_ = jmv._inner(
            keys[split], coords[blk], c_parts, lp[blk],
            None if bl is None else jax.tree_util.tree_map(
                lambda b: b[blk], bl), jnp.asarray(log_u[split]), jm,
            scale=scale)
        coords = coords.at[blk].set(q)
        lp = lp.at[blk].set(lq)
        if bl is not None:
            bl = jax.tree_util.tree_map(lambda b, n: b.at[blk].set(n), bl,
                                        bq)
        jacc.append(np.asarray(done))
        stats.append(st_)
    np.testing.assert_array_equal(acc.numpy(), np.concatenate(jacc))
    np.testing.assert_array_equal(count.numpy(), np.concatenate(jacc))
    np.testing.assert_allclose(st.coords.numpy(), np.asarray(coords),
                               RTOL, ATOL)
    np.testing.assert_allclose(st.log_prob.numpy(), np.asarray(lp), RTOL,
                               ATOL)
    if blobs:
        for a, b in zip(st.blobs, bl):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), RTOL, ATOL)
    w = next(iter(mv._work.values()))
    nexp = sum(float(s[0]) for s in stats)
    ncon = sum(float(s[1]) for s in stats)
    assert w.loop.sums[:, 0].tolist() == [nexp, ncon]
    if tuned:
        np.testing.assert_allclose(float(carry["frac_expand"]),
                                   nexp / max(nexp + ncon, 1.0), 1e-6)
    if kw.get("max_shrink") == 2:
        assert not acc.all()  # a walker that hits max_shrink stays put


def np_uniforms(seed, lane, block, offset):
    return np.float32(uniforms_scalar(seed, lane, block, offset))


def masked_replay(x, lp, seed, offset, ns, mu, max_steps, max_shrink):
    """Neal's loops walker by walker in numpy float32 (the log of the
    level's uniform by torch's ``log``), on the port's draws: the masked
    JAX loops' result (coords, log-probs, acceptance,
    expansions, contractions, the loops' iterations)."""
    f32 = np.float32
    x, lp = x.copy(), lp.copy()
    nw, nd = x.shape
    ng = nw // ns
    nc = nw - ng
    acc = np.zeros(nw, bool)
    nexp = ncon = 0
    its = [0, 0]
    for split in range(ns):
        lo = split * ng
        c_rows = [r for r in range(nw) if not lo <= r < lo + ng]
        new = []
        it_out, it_shr = int(max_steps > 0), 0
        for i in range(ng):
            row = lo + i
            u = np_uniforms(seed, row, SLICE_BLOCK, offset)
            pi = min(int(f32(u[0] * f32(nc))), nc - 1)
            pj = min(int(f32(u[1] * f32(nc - 1))), nc - 2)
            pj = pj + 1 if pj >= pi else pj
            eta = f32(mu) * (x[c_rows[pi]] - x[c_rows[pj]])
            lu = torch.log(torch.tensor(np_uniforms(seed, i, split,
                                                    offset)[1])).numpy()
            y = f32(lp[row] + lu)
            L = -u[2]
            R = f32(L + f32(1.0))
            jl = min(int(f32(u[3] * f32(max_steps))), max_steps - 1)
            s = x[row]
            cnt = {}
            for side, j in ((0, jl), (1, max_steps - 1 - jl)):
                c = 0
                while c < j:
                    v = L if side == 0 else R
                    if not lp_rows(s + v * eta) > y:
                        break
                    if side == 0:
                        L = f32(L - f32(1.0))
                    else:
                        R = f32(R + f32(1.0))
                    c += 1
                cnt[side] = c
            nexp += cnt[0] + cnt[1]
            it_out = max(it_out, 1 + max(cnt.values())) if max_steps else 0
            landed = None
            for k in range(max_shrink):
                uk = np_uniforms(seed, row, SHRINK_BLOCK | k, offset)[0]
                t = f32(L + f32(uk * f32(R - L)))
                lpt = lp_rows(s + t * eta)
                it_shr = max(it_shr, k + 1)
                if lpt > y:
                    landed = (t, lpt)
                    break
                ncon += 1
                if t < 0:
                    L = t
                else:
                    R = t
            new.append((row, eta, landed))
        for row, eta, landed in new:
            if landed is not None:
                x[row] = x[row] + landed[0] * eta
                lp[row] = landed[1]
                acc[row] = True
        its[0] += it_out
        its[1] += it_shr
    return x, lp, acc, nexp, ncon, its


@pytest.mark.parametrize("nd,ng,ns,kw,loops", [
    (1, 17, 2, {}, (1, 1)),
    (3, 20, 2, dict(mu=3.0), (4, 32)),
    (5, 13, 3, dict(mu=20.0, max_steps=2, max_shrink=3), (3, 2)),
    (2, 40, 2, dict(max_steps=1, max_shrink=1), (2, 1)),
])
def test_compacted_route_equals_the_masked_replay(nd, ng, ns, kw, loops):
    nw = ng * ns
    mv = moves.EnsembleSliceMove(randomize_split=False, nsplits=ns, **kw)
    mv.loop_block, mv.bucket_floor = loops
    mv.count_evals = True
    x, st = start(nw, nd, 5 * nd + ng, False)
    want = masked_replay(x, st.log_prob.numpy(), 11, 4, ns, mv.mu,
                         mv.max_steps, mv.max_shrink)
    model = Model(wrap_log_prob_fn(lp_rows, vectorize=True), nw, nd)
    st, acc, _ = mv.propose((11, 4), st, model, (),
                            loops=EagerLoops(mv.loop_block))
    assert np.array_equal(st.coords.numpy(), want[0])
    assert np.array_equal(st.log_prob.numpy(), want[1])
    assert np.array_equal(acc.numpy(), want[2])
    w = next(iter(mv._work.values()))
    assert w.loop.sums[:, 0].tolist() == [want[3], want[4]]
    assert w.iterations.tolist() == want[5]
    # Every listed entry is one evaluation the walker needs; the rows
    # evaluated hold them and at most a bucket's padding a trip.
    assert int(w.evals[1]) == want[4] + int(acc.sum())
    assert bool((w.rows >= w.evals).all())


@pytest.mark.parametrize("T,K", [(1, 1), (3, 7), (2, 300), (5, 1024)])
def test_stable_compaction_is_nonzero_order(T, K):
    g = torch.Generator().manual_seed(T * K)
    for p in (0.0, 0.1, 0.5, 1.0):
        mask = torch.rand(T, K, generator=g) < p
        order, count = sk.compact_plain(mask)
        for r in range(T):
            nz = torch.nonzero(mask[r]).flatten()
            assert int(count[r]) == nz.numel()
            assert torch.equal(order[r, :nz.numel()], nz)
            assert torch.equal(torch.sort(order[r]).values, torch.arange(K))


@pytest.mark.parametrize("ng", [1, 5, 16, 37, 50000])
def test_bucket_rule_at_its_edges(ng):
    for top in (2 * ng, ng):
        for floor in (1, 32, 4096):
            lad = buckets(top, floor)
            assert lad[-1] == top and lad == sorted(set(lad))
            assert all(b >= min(floor, top) for b in lad)
            assert bucket_of(0, top, floor) == lad[0]
            assert bucket_of(1, top, floor) == lad[0]
            assert bucket_of(top, top, floor) == top
            for b in lad:
                assert bucket_of(b, top, floor) == b
                if b > 1 and b - 1 > (lad[lad.index(b) - 1]
                                      if lad.index(b) else 0):
                    assert bucket_of(b - 1, top, floor) == b
            p = 1
            while p < top:
                got = bucket_of(p, top, floor)
                assert got >= p and got in lad
                p *= 2
    with pytest.raises(ValueError):
        bucket_of(2 * ng + 1, 2 * ng)


@pytest.mark.parametrize("shuffled,blobs", [(False, True), (True, False)])
def test_rung_axis_equals_each_rung_alone(shuffled, blobs):
    T, ng, nd = 3, 10, 2
    nw = 2 * ng
    keys = rung_keys(9, T, "cpu")
    xs = torch.from_numpy(np.random.default_rng(2).normal(
        size=(T, nw, nd)).astype(np.float32))
    fn = lp_blobs if blobs else lp_rows

    lp1 = wrap_log_prob_fn(fn, vectorize=True)

    def lp3(q):  # every rung's rows as one batch
        lpq, b = lp1(q.reshape(-1, nd))
        lead = q.shape[:-1]
        return lpq.reshape(lead), (None if b is None else tuple(
            v.reshape(lead + v.shape[1:]) for v in b))

    def run(x, seed, rungs):
        mv = moves.EnsembleSliceMove(randomize_split=shuffled, tune_mu=True)
        mv.bucket_floor = 4
        lp, bl = (lp3 if rungs else lp1)(x)
        st = State(x.clone(), lp, None if bl is None else tuple(
            b.clone() for b in bl))
        carry = mv.init_carry(nw, nd, device="cpu")
        m = Model(lp3 if rungs else lp1, nw, nd)
        if rungs:
            carry = {k: v.expand((T,)).clone() for k, v in carry.items()}
            carry["log_adj"].copy_(torch.tensor([0.1, -0.2, 0.3]))
            st, acc, carry = mv.propose_rungs((seed, 5), st, m, carry)
        else:
            carry["log_adj"].fill_([0.1, -0.2, 0.3][keys.seeds.index(seed)])
            st, acc, carry = mv.propose((seed, 5), st, m, carry)
        return st, acc, carry

    st, acc, carry = run(xs, keys, True)
    for r in range(T):
        sr, ar, cr = run(xs[r], keys.seeds[r], False)
        assert torch.equal(st.coords[r], sr.coords)
        assert torch.equal(st.log_prob[r], sr.log_prob)
        assert torch.equal(acc[r], ar)
        if blobs:
            for a, b in zip(st.blobs, sr.blobs):
                assert torch.equal(a[r], b)
        for k in carry:
            assert torch.equal(carry[k][r], cr[k]), k


def test_cpu_tensors_run_the_plain_versions():
    """The wrappers take the plain route for CPU tensors, count no launch,
    and refuse another device."""
    before = [f.launches for f in (sk.slice_setup, sk.slice_step_out,
                                   sk.slice_shrink, sk.slice_finish)]
    mv = moves.EnsembleSliceMove()
    _, st = start(20, 2, 0, False)
    mv.propose((1, 0), st, Model(wrap_log_prob_fn(lp_rows, vectorize=True),
                                 20, 2), ())
    assert [f.launches for f in (sk.slice_setup, sk.slice_step_out,
                                 sk.slice_shrink, sk.slice_finish)] == before
    x = torch.zeros(1, 8, 2, device="meta")
    with pytest.raises(ValueError, match="no K9 kernel"):
        sk.slice_step_out(x, None, 0, 2, None, 4, 0, None)
    assert philox4x32_scalar((0, 0, 0, 0), split_key(0))  # the stream
