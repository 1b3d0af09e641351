"""Exact parity of the port's K1, K2 and blocked stretch step with the JAX
package, under injected uniforms.

The same numpy-seeded coordinates and uniforms go to both packages.  The
arithmetic is the same float32 expression on both sides, so the
tolerance is float32 rounding (rtol 1e-5, atol 1e-6) and the acceptance
vectors must be identical.  JAX runs on the CPU (tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu.model import Model as JModel
from emcee_tpu.moves import StretchMove as JStretchMove
from emcee_tpu.state import State as JState

from emcee_tpu_torch.model import Model, wrap_log_prob_fn
from emcee_tpu_torch.moves import StretchMove
from emcee_tpu_torch.moves.red_blue import shuffled_order
from emcee_tpu_torch.ops.accept_kernel import accept_select_plain
from emcee_tpu_torch.ops.stretch_kernel import stretch_propose_plain
from emcee_tpu_torch.state import State

RTOL, ATOL = 1e-5, 1e-6


# A unit Gaussian whose log-prob is NaN where x[:, 0] > 0.8, so that some
# proposals hit the NaN-rejects rule.
def jax_gauss_nan(x):
    lp = -0.5 * jnp.sum(x**2, axis=-1)
    return jnp.where(x[:, 0] > 0.8, jnp.nan, lp), None


def torch_gauss_nan(x):
    lp = -0.5 * (x**2).sum(-1)
    return torch.where(x[:, 0] > 0.8, torch.nan, lp)


def blocks(coords, ns):
    ng = coords.shape[0] // ns
    return [coords[j * ng:(j + 1) * ng] for j in range(ns)]


def uniforms(rng, *shape):
    return rng.uniform(size=shape).astype(np.float32)


@pytest.mark.parametrize("nsplits", [2, 4])
@pytest.mark.parametrize("scale", [None, 0.7])
def test_k1_roll_matches_jax_get_proposal(nsplits, scale):
    rng = np.random.default_rng(10 + nsplits)
    nw, nd = 48, 3
    ng = nw // nsplits
    coords = rng.normal(size=(nw, nd)).astype(np.float32)
    jmove = JStretchMove(pair_mode="roll", nsplits=nsplits)
    jmodel = JModel(compute_log_prob=lambda q: (jnp.zeros(q.shape[0]), None),
                    nwalkers=nw)
    for split in range(nsplits):
        extra = uniforms(rng, ng + 1)
        if split == 1:
            extra[ng] = 1.0 - 2.0**-24  # shift at the top of its range
        bl = blocks(coords, nsplits)
        c_parts = tuple(jnp.asarray(b) for j, b in enumerate(bl)
                        if j != split)
        jq, jf = jmove.get_proposal(
            jax.random.key(0), jnp.asarray(bl[split]), c_parts, jmodel,
            extra=jnp.asarray(extra),
            scale=None if scale is None else jnp.float32(scale),
        )
        q, f = stretch_propose_plain(
            torch.from_numpy(coords), split, nsplits, a=2.0,
            scale=None if scale is None else torch.tensor(scale),
            ndim_global=nd, pair_mode="roll",
            u_z=torch.from_numpy(extra[:ng]),
            u_shift=torch.from_numpy(extra[ng:]).reshape(()),
        )
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), RTOL, ATOL)
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), RTOL, ATOL)


def test_k1_through_the_move_matches_the_plain_version():
    """StretchMove.get_proposal(extra=) feeds K1 the JAX package's extra
    layout; on the CPU that is the plain version."""
    rng = np.random.default_rng(3)
    nw, nd = 16, 2
    coords = torch.from_numpy(rng.normal(size=(nw, nd)).astype(np.float32))
    model = Model(compute_log_prob=None, nwalkers=nw, ndim=nd)
    extra = torch.from_numpy(uniforms(rng, 2 * (nw // 2)))
    for pair_mode in ("roll", "random"):
        mv = StretchMove(pair_mode=pair_mode)
        q, f = mv.get_proposal((0, 0), coords, 1, model, extra=extra)
        ng = nw // 2
        kw = dict(u_z=extra[:ng])
        if pair_mode == "roll":
            kw["u_shift"] = extra[ng]
        else:
            kw["u_pair"] = extra[ng:]
        qp, fp = stretch_propose_plain(coords, 1, 2, a=2.0, ndim_global=nd,
                                       pair_mode=pair_mode, **kw)
        assert torch.equal(q, qp) and torch.equal(f, fp)


def test_k1_random_partners_stay_in_the_complement():
    nw, nd, ns = 40, 2, 4
    coords = torch.arange(nw, dtype=torch.float32)[:, None].repeat(1, nd)
    ng = nw // ns
    rng = np.random.default_rng(4)
    seen = set()
    for split in range(ns):
        for _ in range(5):
            # u_z = 0 gives z = 1/a = 1/2, so q = (c_r + s) / 2 reveals the
            # partner row c_r = 2 q - s.
            u_z = torch.zeros(ng)
            u_pair = torch.from_numpy(uniforms(rng, ng))
            q, _ = stretch_propose_plain(coords, split, ns, a=2.0,
                                         ndim_global=nd, pair_mode="random",
                                         u_z=u_z, u_pair=u_pair)
            s = coords[split * ng:(split + 1) * ng]
            partner = (2 * q - s)[:, 0].round().long()
            assert ((partner < split * ng)
                    | (partner >= (split + 1) * ng)).all()
            seen.update(partner.tolist())
    assert len(seen) > nw // 2


@pytest.mark.parametrize("nsplits", [2, 4])
def test_k2_matches_jax_inner_including_nan_rejects(nsplits):
    rng = np.random.default_rng(20 + nsplits)
    nw, nd = 64, 2
    ng = nw // nsplits
    coords = rng.normal(size=(nw, nd)).astype(np.float32)
    lp = (-0.5 * (coords**2).sum(-1)).astype(np.float32)
    jmove = JStretchMove(pair_mode="roll", nsplits=nsplits)
    jmodel = JModel(compute_log_prob=jax_gauss_nan, nwalkers=nw)
    lp_model = wrap_log_prob_fn(torch_gauss_nan, vectorize=True)
    t_coords, t_lp = torch.from_numpy(coords.copy()), torch.from_numpy(lp.copy())
    accepted = torch.zeros(nw, dtype=torch.bool)
    count = torch.zeros(nw, dtype=torch.int32)
    n_nan = 0
    for split in range(nsplits):
        extra = uniforms(rng, ng + 1)
        log_u = np.log(uniforms(rng, ng))
        bl = blocks(coords, nsplits)
        c_parts = tuple(jnp.asarray(b) for j, b in enumerate(bl)
                        if j != split)
        sel_c, sel_lp, _, jacc, _ = jmove._inner(
            jax.random.key(1), jnp.asarray(bl[split]), c_parts,
            jnp.asarray(lp[split * ng:(split + 1) * ng]), None,
            jnp.asarray(log_u), jmodel, extra=jnp.asarray(extra),
        )
        # The JAX reference reads the pre-update ensemble for every split;
        # so does the port here, because each split is checked on a fresh
        # copy of the same arrays.
        c_now, lp_now = t_coords.clone(), t_lp.clone()
        q, f = stretch_propose_plain(
            torch.from_numpy(coords), split, nsplits, a=2.0, ndim_global=nd,
            pair_mode="roll", u_z=torch.from_numpy(extra[:ng]),
            u_shift=torch.tensor(extra[ng]),
        )
        lp_q, _ = lp_model(q)
        n_nan += int(torch.isnan(lp_q).sum())
        acc = accept_select_plain(q, f, lp_q, c_now, lp_now, split, nsplits,
                                  accepted, count,
                                  log_u=torch.from_numpy(log_u))
        sl = slice(split * ng, (split + 1) * ng)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
        np.testing.assert_allclose(c_now[sl].numpy(), np.asarray(sel_c),
                                   RTOL, ATOL)
        np.testing.assert_allclose(lp_now[sl].numpy(), np.asarray(sel_lp),
                                   RTOL, ATOL)
        # Rows outside the split are untouched.
        other = torch.ones(nw, dtype=torch.bool)
        other[sl] = False
        assert torch.equal(c_now[other], t_coords[other])
        assert torch.equal(count[sl], acc.to(torch.int32))
        assert not torch.isnan(lp_now).any()
    assert n_nan > 0, "the NaN branch was not exercised"


@pytest.mark.parametrize("scale", [None, 1.3])
def test_blocked_step_matches_jax_for_20_proposals(scale):
    """20 consecutive proposals of the port's chain; before each one the
    JAX step starts from the port's current state, so the float32
    rounding differences of the two compilers (XLA fuses ``c - (c - s) z``
    where eager PyTorch rounds each operation) are compared one step at
    a time instead of compounding along the chain."""
    rng = np.random.default_rng(5)
    nw, nd, ns = 32, 3, 2
    ng = nw // ns
    coords = rng.normal(size=(nw, nd)).astype(np.float32)
    lp = (-0.5 * (coords**2).sum(-1)).astype(np.float32)

    jmove = JStretchMove(randomize_split=False, pair_mode="roll")
    jmodel = JModel(
        compute_log_prob=lambda q: (-0.5 * jnp.sum(q**2, axis=-1), None),
        nwalkers=nw,
    )
    jscale = None if scale is None else jnp.float32(scale)
    jstep = jax.jit(
        lambda st, la, ex: jmove._propose_blocked(
            jax.random.split(jax.random.key(0), ns), la, ex, st, jmodel, (),
            ng, jscale,
        )
    )
    move = StretchMove(randomize_split=False, pair_mode="roll")
    model = Model(
        compute_log_prob=wrap_log_prob_fn(lambda x: -0.5 * (x**2).sum(-1),
                                          vectorize=True),
        nwalkers=nw, ndim=nd,
    )
    state = State(torch.from_numpy(coords.copy()), torch.from_numpy(lp.copy()),
                  None, (0, 0))
    tscale = None if scale is None else torch.tensor(scale)
    n_acc = 0
    for step in range(20):
        log_acc_u = np.log(uniforms(rng, ns, ng))
        extra_u = uniforms(rng, ns, ng + 1)
        # Copies: the port's step below writes its tensors in place.
        jstate = JState(jnp.asarray(state.coords.numpy().copy()),
                        jnp.asarray(state.log_prob.numpy().copy()))
        jstate, jacc, _ = jstep(jstate, jnp.asarray(log_acc_u),
                                jnp.asarray(extra_u))
        state, acc, _ = move._propose_blocked(
            (0, step), state, model, (), ng, tscale,
            log_acc_u=torch.from_numpy(log_acc_u),
            extra_u=torch.from_numpy(extra_u),
        )
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
        np.testing.assert_allclose(state.coords.numpy(),
                                   np.asarray(jstate.coords), RTOL, ATOL)
        np.testing.assert_allclose(state.log_prob.numpy(),
                                   np.asarray(jstate.log_prob), RTOL, ATOL)
        n_acc += int(acc.sum())
    assert 0.2 * 20 * nw < n_acc < 0.9 * 20 * nw


def test_shuffled_groups_are_strided_slices_of_a_permutation():
    nw, ns = 24, 3
    order = shuffled_order((9, 4), nw, ns, "cpu")
    assert sorted(order.tolist()) == list(range(nw))
    again = shuffled_order((9, 4), nw, ns, "cpu")
    assert torch.equal(order, again)
    assert not torch.equal(order, shuffled_order((9, 5), nw, ns, "cpu"))


def test_shuffled_step_is_the_blocked_step_on_permuted_rows():
    rng = np.random.default_rng(8)
    nw, nd, ns = 24, 2, 3
    coords = torch.from_numpy(rng.normal(size=(nw, nd)).astype(np.float32))
    lp = -0.5 * (coords**2).sum(-1)
    model = Model(
        compute_log_prob=wrap_log_prob_fn(lambda x: -0.5 * (x**2).sum(-1),
                                          vectorize=True),
        nwalkers=nw, ndim=nd,
    )
    rs = (4, 11)
    order = shuffled_order(rs, nw, ns, "cpu")
    shuffled = StretchMove(nsplits=ns)
    st, acc, _ = shuffled.propose(rs, State(coords.clone(), lp.clone()), model,
                                  ())
    blocked = StretchMove(nsplits=ns, randomize_split=False)
    pst = State(coords[order].clone(), lp[order].clone())
    pst, pacc, _ = blocked.propose(rs, pst, model, ())
    assert torch.equal(st.coords[order], pst.coords)
    assert torch.equal(st.log_prob[order], pst.log_prob)
    assert torch.equal(acc[order], pacc)


def test_red_blue_guards():
    model = Model(compute_log_prob=None, nwalkers=4, ndim=3)
    st = State(torch.zeros(4, 3), torch.zeros(4))
    with pytest.raises(RuntimeError, match="unadvisable"):
        StretchMove().propose((0, 0), st, model, ())
    model = Model(compute_log_prob=None, nwalkers=9, ndim=1)
    st = State(torch.zeros(9, 1), torch.zeros(9))
    with pytest.raises(ValueError, match="divisible"):
        StretchMove().propose((0, 0), st, model, ())


def test_accept_update_matches_jax():
    from emcee_tpu.moves.base import accept_update as j_accept_update

    from emcee_tpu_torch.moves.base import accept_update

    rng = np.random.default_rng(12)
    nw, nd = 10, 3
    coords, q = (rng.normal(size=(nw, nd)).astype(np.float32)
                 for _ in range(2))
    lp, lq = (rng.normal(size=nw).astype(np.float32) for _ in range(2))
    acc = rng.uniform(size=nw) < 0.5
    jst = j_accept_update(JState(jnp.asarray(coords), jnp.asarray(lp)),
                          jnp.asarray(q), jnp.asarray(lq), None,
                          jnp.asarray(acc))
    st = accept_update(State(torch.from_numpy(coords), torch.from_numpy(lp)),
                       torch.from_numpy(q), torch.from_numpy(lq),
                       torch.from_numpy(acc))
    np.testing.assert_array_equal(st.coords.numpy(), np.asarray(jst.coords))
    np.testing.assert_array_equal(st.log_prob.numpy(),
                                  np.asarray(jst.log_prob))
