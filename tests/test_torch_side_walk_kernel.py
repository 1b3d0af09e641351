"""K5a's side mode, K8b's walk mode, K18a and K18b: the side and walk
moves' kernels (``emcee_tpu_torch/ops/de_kernel.py``,
``ops/dime_kernel.py``, ``ops/walk_kernel.py``), their plain versions on
the CPU.

Against the JAX package: K5a's side mode against ``SideMove.
get_proposal`` under its own draws, reproduced and injected as
``tests/test_torch_side_blended.py`` does (its tolerances, both pair
modes, with and without a scale); the shared walk route (K8a, K8b's walk
mode, K18a) against ``WalkMove.get_proposal`` and ``_cov`` under JAX's
normals at rtol = atol = 1e-5, as ``tests/test_torch_walk_kde.py`` holds
it (ndim 1, 5 and 33; a singular complement, where the port's factor is
NaN everywhere and JAX's on and below the diagonal).  K18b against its
formula ``X_c^T z / sqrt(s0 - 1)`` in float64: exact and bootstrap
subsets, ``s0`` 2 and ``nc - 1``, ties in the 24-bit keys, an
``exact_subset_max`` above 4096.  Within the port, bit for bit: each
plain version on the rung axis against each rung alone, injected, from
the stream and at a device offset word.  JAX runs on the CPU
(tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu.model import Model as JModel
from emcee_tpu.moves import SideMove as JSideMove
from emcee_tpu.moves import WalkMove as JWalkMove
from emcee_tpu.moves.walk import _cov as jax_cov

from emcee_tpu_torch.ops.de_kernel import de_propose_plain
from emcee_tpu_torch.ops.dime_kernel import (
    dime_finish_plain, dime_moments_plain)
from emcee_tpu_torch.ops.philox import (
    PICK_BLOCK, DeviceOffset, normals, row_uniforms, row_words, rung_keys)
from emcee_tpu_torch.ops.walk_kernel import (
    walk_propose_plain, walk_subset_plain)
from tests.test_torch_side_blended import RTOL as SIDE_RTOL
from tests.test_torch_side_blended import jax_side_draws

WALK_TOL = 1e-5  # tests/test_torch_walk_kde.py


def jmodel(nw):
    return JModel(compute_log_prob=None, nwalkers=nw)


def parts(x, split, ng, ns=2):
    """Group ``split`` and the other groups, as JAX takes them."""
    bl = [x[j * ng:(j + 1) * ng] for j in range(ns)]
    return jnp.asarray(bl[split]), tuple(jnp.asarray(b) for j, b in
                                         enumerate(bl) if j != split)


@pytest.mark.parametrize("pair_mode", ["roll", "random"])
@pytest.mark.parametrize("scale", [None, 0.7])
def test_side_mode_matches_jax(pair_mode, scale):
    nw, nd = 40, 3
    ng = nw // 2
    x = np.random.default_rng(5).normal(size=(nw, nd)).astype(np.float32)
    jmove = JSideMove(pair_mode=pair_mode)
    sigma = jmove._sigma(nd)
    for split in (0, 1):
        key = jax.random.key(21 + split)
        s, c_parts = parts(x, split, ng)
        kw = {} if scale is None else {"scale": jnp.float32(scale)}
        jq, jf = jmove.get_proposal(key, s, c_parts, jmodel(nw), **kw)
        q, f = de_propose_plain(
            torch.from_numpy(x), split, 2, gamma0=sigma,
            scale=None if scale is None else torch.tensor(scale),
            pair_mode=pair_mode, mode="side",
            **jax_side_draws(key, pair_mode, ng, nw - ng))
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), SIDE_RTOL,
                                   SIDE_RTOL)
        assert not f.any() and not np.asarray(jf).any()


def shared_walk(x, split, scale=None, z=None, seed=1, offset=2):
    """The port's shared route on the CPU: K8a, K8b's walk mode, K18a."""
    nw = x.shape[-2]
    ng = nw // 2
    part = dime_moments_plain(x, (split * ng, ng), None, None, 1)
    L = dime_finish_plain(part, mode="walk")
    return L, walk_propose_plain(x, split, 2, L, seed, offset, scale, z)


@pytest.mark.parametrize("nw,nd", [(40, 1), (400, 5), (200, 33)])
@pytest.mark.parametrize("scale", [None, 0.6])
def test_shared_walk_matches_jax(nw, nd, scale):
    """ndim 1, 5 (a complement of two runs, merged by Chan's combine) and
    33; the factor against ``cholesky(_cov(c))``, the proposal against
    ``get_proposal`` under its key's normals."""
    ng = nw // 2
    x = np.random.default_rng(nd).normal(size=(nw, nd)).astype(np.float32)
    x += np.float32(3.0)  # away from 0: the runs' means are offsets
    jmove = JWalkMove()
    for split in (0, 1):
        key = jax.random.key(7 + split)
        s, c_parts = parts(x, split, ng)
        kw = {} if scale is None else {"scale": jnp.float32(scale)}
        jq, _ = jmove.get_proposal(key, s, c_parts, jmodel(nw), **kw)
        z = jax.random.normal(key, (ng, nd), dtype=jnp.float32)
        L, (q, f) = shared_walk(
            torch.from_numpy(x), split,
            None if scale is None else torch.tensor(scale),
            torch.from_numpy(np.array(z)))
        jl = jnp.linalg.cholesky(jax_cov(jnp.concatenate(c_parts)))
        np.testing.assert_allclose(L.numpy(), np.asarray(jl), WALK_TOL,
                                   WALK_TOL)
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), WALK_TOL,
                                   WALK_TOL)
        assert not f.any()


def test_shared_walk_singular_complement():
    """A constant column: the port's factor is NaN everywhere, JAX's on
    and below the diagonal; every proposal is NaN in both."""
    nw, nd = 20, 3
    ng = nw // 2
    x = np.random.default_rng(0).normal(size=(nw, nd)).astype(np.float32)
    x[:, 1] = 2.0
    key = jax.random.key(3)
    s, c_parts = parts(x, 0, ng)
    jq, _ = JWalkMove().get_proposal(key, s, c_parts, jmodel(nw))
    jl = np.asarray(jnp.linalg.cholesky(jax_cov(jnp.concatenate(c_parts))))
    L, (q, _) = shared_walk(torch.from_numpy(x), 0)
    assert torch.isnan(L).all() and torch.isnan(q).all()
    assert np.isnan(jl[np.tril_indices(nd)]).all()
    assert np.isnan(np.asarray(jq)).all()


def subset_want(x, split, ng, picks, z, s0):
    """``s + X_c^T z / sqrt(s0 - 1)`` in float64."""
    x = x.double().numpy()
    c = np.concatenate([x[:split * ng], x[(split + 1) * ng:]])
    sub = c[picks.numpy()]
    xc = sub - sub.mean(axis=1, keepdims=True)
    return x[split * ng:(split + 1) * ng] + np.einsum(
        "gs,gsd->gd", z.double().numpy(), xc) / np.sqrt(s0 - 1)


@pytest.mark.parametrize("nw,ns,s0,exact_max", [
    (40, 2, 2, 4096), (40, 2, 19, 4096), (40, 2, 2, 4), (40, 2, 19, 4),
    (24, 3, 15, 4096)])
def test_subset_matches_its_formula(nw, ns, s0, exact_max):
    """Exact and bootstrap subsets of ``s0`` 2 and ``nc - 1``, both
    splits, from the plain version's own draws (the picks and normals of
    ``moves/walk.py``'s counters)."""
    nd = 3
    ng = nw // ns
    nc = nw - ng
    x = torch.from_numpy(np.random.default_rng(s0).normal(
        size=(nw, nd)).astype(np.float32))
    for split in range(ns):
        row0 = split * ng
        q, f = walk_subset_plain(x, split, ns, s0, exact_max, 8, 9)
        if nc <= exact_max:
            keys = row_uniforms(ng, nc, 8, 9, "cpu", row0=row0)
            picks = torch.argsort(keys, dim=1, stable=True)[:, :s0]
            assert all(len(set(p.tolist())) == s0 for p in picks)
        else:
            u = row_uniforms(ng, s0, 8, 9, "cpu", row0=row0)
            picks = torch.clamp((u * nc).to(torch.int64), max=nc - 1)
        z = normals(ng, s0, 8, 9, "cpu", row0=row0)
        np.testing.assert_allclose(q.numpy(), subset_want(x, split, ng,
                                                           picks, z, s0),
                                   1e-5, 1e-5)
        assert not f.any()
        q2, _ = walk_subset_plain(x, split, ns, s0, exact_max, 8, 9,
                                  z=z, picks=picks)
        assert torch.equal(q, q2)


def test_subset_exact_above_4096_with_ties():
    """``nc`` = 5000 under ``exact_subset_max`` 8192 (the card sorts such a
    subset by K16): the picks are the order of ``(word >> 8, index)``, so
    equal 24-bit keys keep their index order, and the walkers' keys hold
    such ties; ``s0`` 2 and ``nc - 1``."""
    ns, ng, nd = 41, 125, 2
    nw = ns * ng
    nc = nw - ng
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(nw, nd)).astype(np.float32))
    split = 3
    row0 = split * ng
    words = row_words(ng, -(-nc // 4), PICK_BLOCK, 4, 6, "cpu", row0=row0)
    key24 = (torch.stack(words, dim=-1).reshape(ng, -1)[:, :nc] >> 8).numpy()
    ties = sum(len(k) - len(np.unique(k)) for k in key24)
    assert ties > 0
    order = np.stack([np.lexsort((np.arange(nc), k)) for k in key24])
    for s0 in (2, nc - 1):
        picks = torch.from_numpy(order[:, :s0].copy())
        z = normals(ng, s0, 4, 6, "cpu", row0=row0)
        q, _ = walk_subset_plain(x, split, ns, s0, 8192, 4, 6)
        q2, _ = walk_subset_plain(x, split, ns, s0, 8192, 4, 6, z=z,
                                  picks=picks)
        assert torch.equal(q, q2)
        np.testing.assert_allclose(q.numpy(), subset_want(x, split, ng,
                                                           picks, z, s0),
                                   1e-4, 1e-4)


def test_subset_of_one_is_nan():
    """``s0 = 1``: 0 / 0, every proposal NaN (rejected), no guard."""
    x = torch.randn(12, 2, generator=torch.Generator().manual_seed(0))
    for exact_max in (4096, 2):
        q, _ = walk_subset_plain(x, 0, 2, 1, exact_max, 1, 1)
        assert torch.isnan(q).all()


@pytest.mark.parametrize("kw", [dict(mode="side", sigma=0.0),
                                dict(mode="de"), dict(mode="stretch")])
def test_k5a_mode_refuses_its_wrong_arguments(kw):
    """K5a's side mode takes no jitter ``sigma`` (not even 0.0), DE needs
    one, and an unknown mode is refused, by the wrapper and its plain
    version alike."""
    from emcee_tpu_torch.ops.de_kernel import de_propose

    x = torch.randn(8, 2, generator=torch.Generator().manual_seed(0))
    for fn in (de_propose, de_propose_plain):
        with pytest.raises(ValueError):
            fn(x, 0, 2, gamma0=0.5, pair_mode="roll", seed=1, offset=1,
               **kw)


@pytest.mark.parametrize("mode", ["walk", "shared", True])
def test_k8b_mode_is_one_argument(mode):
    """K8b's mode is one argument checked against ``FINISH_MODES``: the
    walk mode needs no carry; any other name is refused."""
    from emcee_tpu_torch.ops.dime_kernel import dime_finish

    x = torch.randn(12, 3, generator=torch.Generator().manual_seed(0))
    part = dime_moments_plain(x, (0, 6), None, None, 1)
    if mode == "walk":
        L = dime_finish(part, mode=mode)
        assert torch.equal(L, dime_finish_plain(part, mode=mode))
        assert L.shape == (3, 3)
        return
    for fn in (dime_finish, dime_finish_plain):
        with pytest.raises(ValueError):
            fn(part, mode=mode)


@pytest.mark.parametrize("draws", ["injected", "stream", "device word"])
def test_rung_axis_plain_versions_equal_each_rung_alone(draws):
    """Bit for bit (``torch.equal``): each rung of K5a's side mode, K8b's
    walk mode, K18a and K18b (exact and bootstrap) on the rung axis is the
    one-ensemble plain version of that rung under ``keys.seeds[r]``,
    every split, a scale per rung; the stream at a host offset and at a
    device word (on the CPU, a 0-d CPU tensor)."""
    gen = torch.Generator().manual_seed(12)
    T, nw, nd, s0 = 3, 24, 3, 4
    ng = nw // 2
    nc = nw - ng
    keys = rung_keys(91, T, "cpu")
    x = torch.randn(T, nw, nd, generator=gen)
    scale = 0.5 + torch.rand(T, generator=gen)
    offset = (DeviceOffset(torch.tensor(5, dtype=torch.int64), 4)
              if draws == "device word" else 9)
    inj = draws == "injected"
    for split in (0, 1):
        for pair_mode in ("roll", "random"):
            kw = {}
            if inj:
                kw = dict(z=torch.randn(T, ng, generator=gen))
                kw |= (dict(u_shift=torch.rand(T, 2, generator=gen))
                       if pair_mode == "roll" else
                       dict(idx_a=torch.randint(0, nc, (T, ng), generator=gen),
                            idx_b=torch.randint(0, nc - 1, (T, ng),
                                                generator=gen)))
            side = dict(gamma0=0.4, pair_mode=pair_mode, mode="side")
            q, _ = de_propose_plain(x, split, 2, scale=scale, seed=keys,
                                    offset=offset, **side, **kw)
            for r in range(T):
                qr, _ = de_propose_plain(x[r], split, 2, scale=scale[r],
                                         seed=keys.seeds[r], offset=9,
                                         **side,
                                         **{k: v[r] for k, v in kw.items()})
                assert torch.equal(qr, q[r]), ("side", split, r)
        part = dime_moments_plain(x, (split * ng, ng), None, None, 1)
        L = dime_finish_plain(part, mode="walk")
        zs = torch.randn(T, ng, nd, generator=gen) if inj else None
        q, _ = walk_propose_plain(x, split, 2, L, keys, offset, scale, zs)
        for exact_max in (4096, 4):
            zb = torch.randn(T, ng, s0, generator=gen) if inj else None
            pb = (torch.randint(0, nc, (T, ng, s0), generator=gen)
                  if inj else None)
            qb, _ = walk_subset_plain(x, split, 2, s0, exact_max, keys,
                                      offset, scale, zb, pb)
            for r in range(T):
                qr, _ = walk_subset_plain(
                    x[r], split, 2, s0, exact_max, keys.seeds[r], 9,
                    scale[r], None if zb is None else zb[r],
                    None if pb is None else pb[r])
                assert torch.equal(qr, qb[r]), ("subset", split, r)
        for r in range(T):
            pr = dime_moments_plain(x[r], (split * ng, ng), None, None, 1)
            Lr = dime_finish_plain(pr, mode="walk")
            assert torch.equal(Lr, L[r]), ("factor", split, r)
            qr, _ = walk_propose_plain(x[r], split, 2, Lr, keys.seeds[r], 9,
                                       scale[r],
                                       None if zs is None else zs[r])
            assert torch.equal(qr, q[r]), ("shared", split, r)
        if not inj:  # the rungs draw apart
            assert not torch.equal(q[0], q[1])
