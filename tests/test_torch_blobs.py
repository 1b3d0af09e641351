"""Blobs in the port against the JAX package.

* Exact: the same numpy uniforms (and, for DE, the JAX draws of each
  split key) go into both packages' ``_propose_blocked`` for the stretch
  and DE moves, and the same accept mask into the JAX ``accept_update``
  and the port's ``MHMove`` (K2 at ``nsplits=1``), with a log-prob
  returning each blob kind: a scalar, a vector, a matrix, an int leaf, a
  tuple and a dict.  Before each proposal the JAX step starts from the
  port's state (``test_torch_moves.py`` says why).  Coords and log-prob
  agree to float32 rounding (rtol 1e-5, atol 1e-6; the two compilers
  round ``c - (c - s) z`` differently); the float blob values are
  ``floor``s of products of q, the same in both packages unless a value
  lies within that rounding of an integer, so every blob leaf must be
  equal.
* Layout: each case of ``tests/unit/test_blobs.py:24-93`` gives the same
  ``get_blobs`` structure, shapes, dtypes and field names in both
  packages, with and without a declared ``blobs_dtype``.
* Invariant: over a stored shuffled-split run every stored blob is the
  function at its stored coords, exactly.
* K2's plain version with blob leaves of six dtypes against numpy's
  ``where``, bytes compared.
* The errors of ``tests/unit/test_blobs.py:95-151`` and
  ``tests/unit/test_backends.py:258-347`` (the HDF ones in
  ``test_torch_hdf.py``).
* Workload 2, the line fit with blobs (``tests/integration/
  test_line_fit.py``): its 5000-step posterior oracle is ``slow``; a
  400-step twin in the fast tier checks the blobs against the log-prob.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import emcee_tpu
from emcee_tpu.model import Model as JModel
from emcee_tpu.moves import DEMove as JDEMove
from emcee_tpu.moves import StretchMove as JStretchMove
from emcee_tpu.moves.base import accept_update as j_accept_update
from emcee_tpu.state import State as JState

import emcee_tpu_torch
from emcee_tpu_torch import moves
from emcee_tpu_torch.backends import Backend, DeviceBackend
from emcee_tpu_torch.model import Model, wrap_log_prob_fn
from emcee_tpu_torch.ops import accept_kernel
from emcee_tpu_torch.ops.accept_kernel import (
    accept_select, accept_select_plain, blob_unit)
from emcee_tpu_torch.state import State
from emcee_tpu_torch.utils import tree_flatten, tree_leaves, tree_map
from tests.test_torch_de import jax_de_draws

RTOL, ATOL = 1e-5, 1e-6
NW, ND = 24, 3


def _blob_fns(xp, floor, to_int):
    """The blob kinds of the exact tests for one array module."""
    def int_leaf(x):
        return to_int((x > 0).sum(-1))

    return {
        "scalar": lambda x: floor(4 * x.sum(-1)),
        "vector": lambda x: floor(4 * x),
        "matrix": lambda x: floor(4 * x[:, :, None] * x[:, None, :]),
        "int": int_leaf,
        "tuple": lambda x: (floor(4 * x.sum(-1)), int_leaf(x)),
        "dict": lambda x: {"v": floor(4 * x), "n": int_leaf(x)},
    }


TORCH_BLOBS = _blob_fns(torch, torch.floor, lambda t: t.int())
JAX_BLOBS = _blob_fns(jnp, jnp.floor, lambda t: t.astype(jnp.int32))


def models(kind, nw=NW, nd=ND):
    jblob, tblob = JAX_BLOBS[kind], TORCH_BLOBS[kind]
    jmodel = JModel(
        compute_log_prob=lambda q: (-0.5 * jnp.sum(q**2, axis=-1),
                                    jblob(q)),
        nwalkers=nw,
    )
    model = Model(
        compute_log_prob=wrap_log_prob_fn(
            lambda x: (-0.5 * (x**2).sum(-1), tblob(x)), vectorize=True),
        nwalkers=nw, ndim=nd,
    )
    return jmodel, model


def start(rng, kind, nw=NW, nd=ND):
    x = rng.normal(size=(nw, nd)).astype(np.float32)
    t = torch.from_numpy(x)
    return State(t, -0.5 * (t**2).sum(-1), TORCH_BLOBS[kind](t), (0, 0))


def as_jax(state):
    return JState(
        jnp.asarray(state.coords.numpy().copy()),
        jnp.asarray(state.log_prob.numpy().copy()),
        tree_map(lambda b: jnp.asarray(b.numpy().copy()), state.blobs))


def check_same(state, jstate, acc, jacc):
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(state.coords.numpy(),
                               np.asarray(jstate.coords), RTOL, ATOL)
    np.testing.assert_allclose(state.log_prob.numpy(),
                               np.asarray(jstate.log_prob), RTOL, ATOL)
    leaves, treedef = tree_flatten(state.blobs)
    jleaves = jax.tree_util.tree_leaves(jstate.blobs)
    assert len(leaves) == len(jleaves)
    for got, want in zip(leaves, jleaves):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


def clone(state):
    return State(state.coords.clone(), state.log_prob.clone(),
                 tree_map(torch.clone, state.blobs), state.random_state)


KINDS = list(TORCH_BLOBS)


@pytest.mark.parametrize("kind", KINDS)
def test_stretch_blocked_blobs_match_jax(kind):
    rng = np.random.default_rng(3)
    ns, ng = 2, NW // 2
    jmodel, model = models(kind)
    jmove = JStretchMove(randomize_split=False, pair_mode="roll")
    move = moves.StretchMove(randomize_split=False, pair_mode="roll")
    state = start(rng, kind)
    n_acc = 0
    for step in range(3):
        log_acc_u = np.log(rng.uniform(size=(ns, ng)).astype(np.float32))
        extra_u = rng.uniform(size=(ns, ng + 1)).astype(np.float32)
        jstate, jacc, _ = jmove._propose_blocked(
            jax.random.split(jax.random.key(0), ns), jnp.asarray(log_acc_u),
            jnp.asarray(extra_u), as_jax(state), jmodel, (), ng)
        state, acc, _ = move._propose_blocked(
            (0, step), clone(state), model, (), ng,
            log_acc_u=torch.from_numpy(log_acc_u),
            extra_u=torch.from_numpy(extra_u))
        check_same(state, jstate, acc, jacc)
        n_acc += int(acc.sum())
    assert 0 < n_acc < 3 * NW


@pytest.mark.parametrize("kind", KINDS)
def test_de_blocked_blobs_match_jax(kind):
    rng = np.random.default_rng(4)
    ns, ng = 2, NW // 2
    jmodel, model = models(kind)
    jmove = JDEMove(sigma=0.2, pair_mode="random", randomize_split=False)
    move = moves.DEMove(sigma=0.2, pair_mode="random",
                        randomize_split=False)
    state = start(rng, kind)
    n_acc = 0
    for step in range(3):
        split_keys = jax.random.split(jax.random.key(step), ns)
        log_acc_u = np.log(rng.uniform(size=(ns, ng)).astype(np.float32))
        jstate, jacc, _ = jmove._propose_blocked(
            split_keys, jnp.asarray(log_acc_u), None, as_jax(state), jmodel,
            (), ng)
        extra = [jax_de_draws(split_keys[j], "random", ng, NW - ng)
                 for j in range(ns)]
        state, acc, _ = move._propose_blocked(
            (0, step), clone(state), model, (), ng,
            log_acc_u=torch.from_numpy(log_acc_u), extra_u=extra)
        check_same(state, jstate, acc, jacc)
        n_acc += int(acc.sum())
    assert 0 < n_acc < 3 * NW


@pytest.mark.parametrize("kind", KINDS)
def test_mh_blobs_match_jax_accept_update(kind):
    """K2 at ``nsplits=1`` (the port's ``MHMove``) against the JAX
    ``accept_update`` under the same accept mask."""
    rng = np.random.default_rng(5)
    jmodel, model = models(kind)
    state = start(rng, kind)
    q = (state.coords.numpy()
         + rng.normal(size=(NW, ND)).astype(np.float32))
    log_u = np.log(rng.uniform(size=NW)).astype(np.float32)
    jq = jnp.asarray(q)
    jlp_q, jblobs_q = jmodel.compute_log_prob(jq)
    jstate = as_jax(state)
    jacc = jnp.asarray(log_u) < (jlp_q - jstate.log_prob)
    jstate = j_accept_update(jstate, jq, jlp_q, jblobs_q, jacc)
    mv = moves.MHMove(lambda rng_, c: (torch.from_numpy(q),
                                       torch.zeros(NW)))
    st, acc, _ = mv.propose((1, 2), clone(state), model, (),
                            log_u=torch.from_numpy(log_u))
    check_same(st, jstate, acc, jacc)
    assert 0 < int(acc.sum()) < NW


def test_accept_update_selects_blobs_like_jax():
    from emcee_tpu_torch.moves.base import accept_update

    rng = np.random.default_rng(6)
    state = start(rng, "dict")
    q = torch.from_numpy(rng.normal(size=(NW, ND)).astype(np.float32))
    acc = torch.from_numpy(rng.uniform(size=NW) < 0.5)
    lp_q, blobs_q = -0.5 * (q**2).sum(-1), TORCH_BLOBS["dict"](q)
    got = accept_update(clone(state), q, lp_q, acc, blobs_q)
    want = j_accept_update(as_jax(state), jnp.asarray(q.numpy()),
                           jnp.asarray(lp_q.numpy()),
                           tree_map(lambda b: jnp.asarray(b.numpy()),
                                    blobs_q),
                           jnp.asarray(acc.numpy()))
    check_same(got, want, acc, acc.numpy())


# -- layout: tests/unit/test_blobs.py:24-93 in both packages ---------------

def _layout_case(name, xp):
    """The log-prob of layout case ``name`` (one walker's vector)."""
    if name == "vector":
        return lambda x: (-0.5 * (x**2).sum(), x)
    if name == "scalar":
        return lambda x: (-0.5 * (x**2).sum(), x.sum())
    if name == "tuple":
        return lambda x: (-0.5 * (x**2).sum(), x.sum(), x * 2.0)
    if name == "dict":
        return lambda x: (-0.5 * (x**2).sum(), {"s": x.sum(), "v": x})
    if name == "int":
        if xp is jnp:
            return lambda x: (-0.5 * jnp.sum(x**2),
                              jnp.argmax(jnp.abs(x)).astype(jnp.int32))
        return lambda x: (-0.5 * (x**2).sum(),
                          torch.argmax(x.abs()).to(torch.int32))
    if name == "matrix":
        if xp is jnp:
            return lambda x: (-0.5 * jnp.sum(x**2), jnp.outer(x, x))
        return lambda x: (-0.5 * (x**2).sum(), torch.outer(x, x))
    # Three uniform returns: stacked under the reference layout.
    return lambda x: (-0.5 * (x**2).sum(), x[0], x[1], x.sum())


#: the declared blobs_dtype of each case (named fields: the JAX package
#: raises on an unnamed declaration, see sampler.get_blobs)
DECLARED = {
    "vector": [("v", float)], "scalar": [("s", float)],
    "tuple": [("s", float), ("v", float)], "dict": [("s", float),
                                                    ("v", float)],
    "int": [("i", int)], "matrix": [("m", float)],
    "stacked": [("a", float), ("b", float), ("c", float)],
}


def _layout(blobs):
    if isinstance(blobs, np.ndarray) and blobs.dtype.names is not None:
        return ("record", blobs.shape,
                [(n, blobs.dtype[n].base.str, blobs.dtype[n].shape)
                 for n in blobs.dtype.names])
    leaves, treedef = jax.tree_util.tree_flatten(blobs)
    return (str(treedef).replace("PyTreeDef", ""),
            [(np.shape(b), np.asarray(b).dtype.str) for b in leaves])


@pytest.mark.parametrize("declared", [False, True])
@pytest.mark.parametrize("name", list(DECLARED))
def test_get_blobs_layout_matches_jax(name, declared):
    nw, nd, nsteps = 16, 2, 4
    p0 = np.random.default_rng(0).normal(size=(nw, nd)).astype(np.float32)
    kw = dict(blobs_dtype=DECLARED[name]) if declared else {}
    # The JAX side stores what its run_mcmc would (the blobs of each kept
    # step stacked on a leading axis) without compiling a chain: the
    # layout comes from the log-prob's wrapper, the backend and
    # get_blobs, not from the moves.
    js = emcee_tpu.EnsembleSampler(nw, nd, _layout_case(name, jnp), seed=0,
                                   **kw)
    lp, blobs = js.compute_log_prob(jnp.asarray(p0))
    js.backend.grow(nsteps, blobs)
    js.backend.save_chunk(
        np.stack([p0] * nsteps), np.stack([np.asarray(lp)] * nsteps),
        jax.tree_util.tree_map(lambda b: np.stack([np.asarray(b)] * nsteps),
                               blobs),
        np.zeros((nsteps, nw), bool), None)
    ts = emcee_tpu_torch.EnsembleSampler(nw, nd, _layout_case(name, torch),
                                         seed=0, device="cpu", **kw)
    ts.run_mcmc(p0, nsteps)
    got, want = ts.get_blobs(), js.get_blobs()
    assert _layout(got) == _layout(want)
    assert _layout(ts.get_blobs(flat=True)) == _layout(
        js.get_blobs(flat=True))
    last, jlast = ts.get_last_sample().blobs, js.get_last_sample().blobs
    assert _layout(last) == _layout(jlast)


def test_blobs_accepted_consistency():
    """Blobs of rejected proposals carry the previous value
    (``test_blobs.py:83-93``): a vector blob equals the chain."""
    s = emcee_tpu_torch.EnsembleSampler(
        16, 2, lambda x: (-0.5 * (x**2).sum(), x), seed=0, device="cpu")
    s.run_mcmc(np.random.default_rng(1).normal(size=(16, 2)), 20)
    np.testing.assert_array_equal(s.get_blobs(), s.get_chain())


# -- the stored-run invariant ------------------------------------------------

def lp_tuple_dict(x):
    return (-0.5 * (x**2).sum(-1),
            {"sum": x.sum(-1), "pos": (x > 0).sum(-1).int(),
             "sq": (x**2).to(torch.float64)})


@pytest.mark.parametrize("backend", [Backend, DeviceBackend])
def test_stored_blobs_are_the_function_at_the_stored_coords(backend):
    """A shuffled-split run (``randomize_split=True``, the reference
    default) stored with ``thin_by=2``: every stored blob is the function
    at its stored coords (a blob row selected for the wrong walker would
    show), exactly, in each leaf's dtype (float64 stays float64)."""
    s = emcee_tpu_torch.EnsembleSampler(
        32, 3, lp_tuple_dict, vectorize=True, seed=4, device="cpu",
        backend=backend(), moves=moves.StretchMove())
    s.run_mcmc(np.random.default_rng(2).normal(size=(32, 3)), 12,
               thin_by=2)
    chain = torch.from_numpy(s.get_chain()).float()  # exact: f32 rows
    want = lp_tuple_dict(chain.reshape(-1, 3))[1]
    got = s.get_blobs()
    assert set(got) == {"sum", "pos", "sq"}
    assert got["sq"].dtype == np.float64 and got["pos"].dtype == np.int32
    for k in got:
        np.testing.assert_array_equal(
            got[k].reshape((-1,) + got[k].shape[2:]), want[k].numpy())
    np.testing.assert_array_equal(
        s.get_log_prob().reshape(-1),
        (-0.5 * (chain**2).sum(-1)).reshape(-1).numpy())
    assert 0.2 < s.acceptance_fraction.mean() < 0.9


def test_state_blobs_resume_and_sample():
    """The last state carries the blobs; a run from it continues the
    chain exactly as one run does, and ``sample`` yields blob states."""
    def make():
        return emcee_tpu_torch.EnsembleSampler(
            32, 3, lp_tuple_dict, vectorize=True, seed=9, device="cpu")

    p0 = np.random.default_rng(3).normal(size=(32, 3))
    one = make()
    one.run_mcmc(p0, 10)
    two = make()
    st = two.run_mcmc(p0, 4)
    assert set(st.blobs) == {"sum", "pos", "sq"}
    two.run_mcmc(st, 6)
    assert two.iteration == 10
    for k in ("sum", "pos", "sq"):
        np.testing.assert_array_equal(one.get_blobs()[k],
                                      two.get_blobs()[k])
    three = make()
    states = list(three.sample(p0, iterations=3))
    assert states[-1].blobs["pos"].dtype == torch.int32
    np.testing.assert_array_equal(three.get_blobs()["sum"],
                                  one.get_blobs()["sum"][:3])


# -- K2's blob leaves ------------------------------------------------------

LEAF_DTYPES = [torch.float32, torch.float64, torch.float16, torch.int32,
               torch.int64, torch.bool]


@pytest.mark.parametrize("nsplits,split", [(1, 0), (2, 0), (2, 1)])
def test_k2_plain_selects_blob_leaves_bytewise(nsplits, split):
    """The plain K2 selects each blob leaf's rows with the coordinates'
    mask, in place, for every dtype and row shape; compared with numpy's
    ``where`` on the leaves' bytes (NaN payloads included)."""
    gen = torch.Generator().manual_seed(11)
    nw, nd = 18, 3
    ng = nw // nsplits
    coords = torch.randn(nw, nd, generator=gen)
    lp = -0.5 * (coords**2).sum(-1)
    q = torch.randn(ng, nd, generator=gen)
    lp_q = -0.5 * (q**2).sum(-1)
    log_u = torch.log(torch.rand(ng, generator=gen))
    pairs, before = [], []
    for dt in LEAF_DTYPES:
        for shape in ((), (1,), (3,), (2, 2), (7,)):
            def leaf(n):
                x = torch.randn((n,) + shape, generator=gen) * 3
                if dt == torch.bool:
                    return x > 0
                x = x.to(dt)
                if dt.is_floating_point:
                    x.view(-1)[::5] = torch.nan
                return x
            pairs.append((leaf(ng), leaf(nw)))
            before.append(pairs[-1][1].clone())
    acc = torch.zeros(nw, dtype=torch.bool)
    accept_select_plain(q, torch.zeros(ng), lp_q, coords, lp, split,
                        nsplits, acc, log_u=log_u, blobs=pairs)
    mask = acc[split * ng:(split + 1) * ng].numpy()
    assert 0 < mask.sum() < ng
    lo = split * ng
    for (new, buf), old in zip(pairs, before):
        want = old.numpy().copy()
        m = mask.reshape((-1,) + (1,) * (new.dim() - 1))
        want[lo:lo + ng] = np.where(m, new.numpy(), want[lo:lo + ng])
        assert buf.numpy().tobytes() == want.tobytes()


def test_k2_wrapper_takes_the_plain_version_on_cpu():
    before = accept_select.launches
    coords = torch.randn(8, 2)
    blob = torch.zeros(8, dtype=torch.int64)
    acc = torch.zeros(8, dtype=torch.bool)
    accept_select(torch.randn(4, 2), torch.zeros(4), torch.full((4,), 9.0),
                  coords, torch.zeros(8), 1, 2, acc,
                  blobs=[(torch.arange(4) + 5, blob)], log_u=torch.zeros(4))
    assert accept_select.launches == before
    assert blob.tolist() == [0, 0, 0, 0, 5, 6, 7, 8]


@pytest.mark.parametrize("src,dst,row,unit", [
    (0, 512, 4, 4), (0, 512, 12, 4), (0, 512, 16, 16), (0, 512, 56, 8),
    (0, 512, 2, 2), (0, 512, 1, 1), (4, 512, 16, 4), (0, 520, 16, 8),
    (1, 512, 16, 1), (0, 512, 6, 2)])
def test_blob_unit_divides_both_bases_and_the_row(src, dst, row, unit):
    assert blob_unit(src, dst, row) == unit
    assert accept_kernel.BLOB_CAPACITY == 16


# -- errors ----------------------------------------------------------------

def test_state_with_log_prob_but_no_blobs_raises():
    """``emcee_tpu/moves/red_blue.py:330-335``: a move given a state
    without blobs whose log-prob returns some."""
    _, model = models("vector")
    st = start(np.random.default_rng(7), "vector")._replace(blobs=None)
    for mv in (moves.StretchMove(randomize_split=False),
               moves.StretchMove(),
               moves.MHMove(lambda r, c: (c + 0.1, torch.zeros(NW)))):
        with pytest.raises(ValueError, match="current list of blobs"):
            mv.propose((0, 0), clone(st), model, ())


def test_inconsistent_blob_use_rejected():
    """``tests/unit/test_backends.py:286-316`` for the host and device
    backends (the HDF one in ``test_torch_hdf.py``)."""
    for make in (Backend, DeviceBackend):
        b = make()
        b.reset(4, 2)
        coords = np.zeros((2, 4, 2))
        lp = np.zeros((2, 4))
        acc = np.zeros((2, 4), np.int32)
        b.save_chunk(coords, lp, np.ones((2, 4), np.float32), acc, None)
        with pytest.raises(ValueError, match="inconsistent use of blobs"):
            b.save_chunk(coords, lp, None, acc, None)
        b2 = make()
        b2.reset(4, 2)
        b2.save_chunk(coords, lp, None, acc, None)
        with pytest.raises(ValueError, match="inconsistent use of blobs"):
            b2.save_chunk(coords, lp, np.ones((2, 4), np.float32), acc,
                          None)


def test_grow_respects_blob_consistency():
    for make in (Backend, DeviceBackend):
        b = make()
        b.reset(4, 2)
        b.save_chunk(np.zeros((2, 4, 2)), np.zeros((2, 4)), None,
                     np.zeros((2, 4), np.int32), None)
        with pytest.raises(ValueError, match="inconsistent use of blobs"):
            b.grow(5, np.zeros((4,), np.float32))


@pytest.mark.parametrize("backend", [Backend, DeviceBackend])
def test_blob_change_between_runs_rejected(backend):
    """A model that stops (or starts) returning blobs cannot continue a
    chain stored with (without) them (``test_blobs.py:113-133``,
    ``test_backends.py:330-347``)."""
    p0 = np.random.default_rng(1).normal(size=(8, 2))
    store = backend()
    s1 = emcee_tpu_torch.EnsembleSampler(
        8, 2, lambda x: (-0.5 * (x**2).sum(), x.sum()), seed=0,
        device="cpu", backend=store)
    s1.run_mcmc(p0, 4)
    s2 = emcee_tpu_torch.EnsembleSampler(
        8, 2, lambda x: -0.5 * (x**2).sum(), seed=0, device="cpu",
        backend=store)
    with pytest.raises(ValueError, match="inconsistent use of blobs"):
        s2.run_mcmc(None, 3)
    store = backend()
    s3 = emcee_tpu_torch.EnsembleSampler(
        8, 2, lambda x: -0.5 * (x**2).sum(), seed=0, device="cpu",
        backend=store)
    s3.run_mcmc(p0, 4)
    s4 = emcee_tpu_torch.EnsembleSampler(
        8, 2, lambda x: (-0.5 * (x**2).sum(), x.sum()), seed=0,
        device="cpu", backend=store)
    with pytest.raises(ValueError, match="inconsistent use of blobs"):
        s4.run_mcmc(None, 3)


def test_blob_without_the_walker_axis_raises():
    s = emcee_tpu_torch.EnsembleSampler(
        8, 2, lambda x: (-0.5 * (x**2).sum(-1), x.sum()), vectorize=True,
        device="cpu")
    with pytest.raises(ValueError, match="walker axis"):
        s.run_mcmc(np.random.default_rng(1).normal(size=(8, 2)), 1)


def test_blobs_dtype_field_count_mismatch_raises():
    s = emcee_tpu_torch.EnsembleSampler(
        8, 2, lambda x: (-0.5 * (x**2).sum(), x.sum(), x[0]), device="cpu",
        blobs_dtype=[("a", float)])
    s.run_mcmc(np.random.default_rng(1).normal(size=(8, 2)), 2)
    with pytest.raises(ValueError, match="declares 1 fields"):
        s.get_blobs()


# -- workload 2: the line fit with blobs -----------------------------------

def line_fit_data(seed=123, n=50):
    """``tests/integration/test_line_fit.py`` ``make_data``."""
    rng = np.random.default_rng(seed)
    m_true, b_true, f_true = -0.9594, 4.294, 0.534
    x = np.sort(10 * rng.uniform(size=n))
    yerr = 0.1 + 0.5 * rng.uniform(size=n)
    y = m_true * x + b_true
    y += np.abs(f_true * y) * rng.normal(size=n)
    y += yerr * rng.normal(size=n)
    return x, y, yerr


def line_fit_log_prob(theta, x, y, yerr):
    """The tutorial's log-prob of one walker, with the log posterior
    itself as the blob (``test_line_fit.py:31-45``)."""
    m, b, log_f = theta[0], theta[1], theta[2]
    in_bounds = ((-5.0 < m) & (m < 0.5) & (0.0 < b) & (b < 10.0)
                 & (-10.0 < log_f) & (log_f < 1.0))
    model = m * x + b
    sigma2 = yerr**2 + torch.exp(2 * log_f) * model**2
    log_like = -0.5 * ((y - model) ** 2 / sigma2 + torch.log(sigma2)).sum()
    lp = torch.where(in_bounds, log_like, -torch.inf)
    return lp, lp


def run_line_fit(nsteps):
    data = [torch.as_tensor(a, dtype=torch.float32)
            for a in line_fit_data()]
    p0 = np.array([-1.0, 4.5, -0.7]) + 1e-4 * np.random.default_rng(
        0).normal(size=(32, 3))
    s = emcee_tpu_torch.EnsembleSampler(32, 3, line_fit_log_prob,
                                        args=data, seed=42, device="cpu")
    s.run_mcmc(p0, nsteps)
    return s


def test_line_fit_blobs_are_the_log_prob():
    """The fast twin of the workload-2 oracle: 400 steps, the blob of
    every stored step equals its log-prob exactly."""
    s = run_line_fit(400)
    np.testing.assert_array_equal(s.get_blobs(), s.get_log_prob())
    assert s.get_blobs().shape == (400, 32)
    assert 0.2 < s.acceptance_fraction.mean() < 0.9


@pytest.mark.slow
def test_line_fit_posterior():
    """``tests/integration/test_line_fit.py``'s oracle on the port."""
    s = run_line_fit(5000)
    tau = s.get_autocorr_time(quiet=True)
    assert np.all(tau < 80), f"tau too large: {tau}"
    discard = int(5 * tau.max())
    flat = s.get_chain(flat=True, discard=discard, thin=10)
    med = np.percentile(flat, 50, axis=0)
    assert abs(med[0] - (-0.9594)) < 0.15, f"m median {med[0]}"
    assert abs(med[1] - 4.294) < 0.6, f"b median {med[1]}"
    assert abs(med[2] - np.log(0.534)) < 0.3, f"log_f median {med[2]}"
    blobs = s.get_blobs(flat=True, discard=discard, thin=10)
    lp = s.get_log_prob(flat=True, discard=discard, thin=10)
    np.testing.assert_allclose(blobs, lp, rtol=1e-5)
