"""K19, the Gaussian proposal (``emcee_tpu_torch/ops/gaussian_kernel.py``,
``csrc/gaussian_propose.cu``), against the JAX package and within the
port.

* Against ``emcee_tpu``'s ``GaussianMove`` proposal
  (``emcee_tpu/moves/gaussian.py:118-150``) under JAX's own draws: the test
  replays its ``jax.random.split(key, 3)``, ``uniform``, ``normal`` and
  ``randint`` and injects them into K19's plain version; scalar, diagonal
  and full covariance, the three modes, with and without a factor, tuned,
  ndim 1, 5 and 33 (rtol = atol = 1e-6; 1e-5 for the full covariance,
  whose column-order sum rounds otherwise than JAX's matmul).
* The stream route against the step of the JAX formula that the move ran
  before (``moves/gaussian.py`` ``gaussian_step`` with the same draws):
  bit for bit for a scalar or diagonal scale, 1e-6 for the full
  covariance.
* The rung axis against each rung alone, bit for bit: injected draws, the
  stream at a host offset and at a device word (a 0-d CPU tensor here).

On the CPU the wrapper runs the plain version; the kernel is held to it
bit for bit on the card (``chip_smoke.py`` phase 26).  JAX runs on the CPU
(tests/conftest.py).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu import moves as jmoves

from emcee_tpu_torch import moves
from emcee_tpu_torch.moves.gaussian import gaussian_step
from emcee_tpu_torch.ops import gaussian_kernel as gk
from emcee_tpu_torch.ops.philox import (
    DeviceOffset, normals, roll_uniforms, rung_keys, word_uniforms)

TOL = 1e-6
FULL_TOL = 1e-5
NW = 12
#: (cov kind, mode): a full covariance takes the vector mode only
CASES = [("scalar", "vector"), ("scalar", "random"), ("scalar", "sequential"),
         ("diag", "vector"), ("diag", "random"), ("diag", "sequential"),
         ("full", "vector")]


def seed_of(*parts):
    """A seed fixed by ``parts`` (Python's own string hash varies by run)."""
    return zlib.crc32(repr(parts).encode())


def make_cov(kind, nd, rng):
    if kind == "scalar":
        return 0.7
    if kind == "diag":
        return 0.3 + rng.uniform(size=nd)
    a = rng.normal(size=(nd, nd))
    return a @ a.T / nd + 0.5 * np.eye(nd)


def jax_draws(key, nw, nd, lf):
    """JAX's draws of one proposal (``gaussian.py:121-145``): the factor's
    unit uniform, the normals and the random mode's dimensions."""
    k_f, k_n, k_m = jax.random.split(key, 3)
    return dict(
        u=torch.tensor(float(jax.random.uniform(k_f, ())), dtype=torch.float32)
        if lf is not None else None,
        z=torch.from_numpy(np.array(jax.random.normal(k_n, (nw, nd),
                                                      dtype=jnp.float32))),
        dims=torch.from_numpy(np.array(jax.random.randint(
            k_m, (nw,), 0, nd)).astype(np.int64)))


@pytest.mark.parametrize("kind,mode", CASES)
@pytest.mark.parametrize("factor", [None, 2.5])
@pytest.mark.parametrize("tuned", [False, True])
def test_plain_version_matches_jax_proposal(kind, mode, factor, tuned):
    rng = np.random.default_rng(seed_of((kind, mode, factor, tuned)) % 2**31)
    for nd in (1, 5, 33):
        cov = make_cov(kind, nd, rng)
        jm = jmoves.GaussianMove(cov, mode=mode, factor=factor)
        mv = moves.GaussianMove(cov, mode=mode, factor=factor)
        x = rng.normal(size=(NW, nd)).astype(np.float32)
        log_adj = np.float32(rng.normal() * 0.3) if tuned else None
        jcarry = {}
        carry = {}
        if mode == "sequential":
            jcarry["index"] = jnp.int32(7)
            carry["index"] = torch.tensor(7, dtype=torch.int32)
        if tuned:
            jcarry["log_adj"] = jnp.float32(log_adj)
        key = jax.random.key(int(rng.integers(1 << 30)))
        jq, jf, jc = jm.get_proposal(key, jnp.asarray(x), jcarry)
        d = jax_draws(key, NW, nd, mv._log_factor)
        scale, chol = mv._tensors("cpu", torch.float32)
        q, f = gk.gaussian_propose_plain(
            torch.from_numpy(x), scale, chol, 0, 0, mode, mv._log_factor,
            None if log_adj is None else torch.tensor(log_adj),
            carry.get("index"), z=d["z"], u=d["u"],
            dims=d["dims"] if mode == "random" else None)
        tol = FULL_TOL if kind == "full" else TOL
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), tol, tol)
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
        if mode != "vector":
            changed = (q.numpy() != x).sum(axis=1)
            assert np.all(changed <= 1)
        if mode == "sequential":
            assert int(carry["index"]) == int(jc["index"]) == (7 + 1) % nd


def old_route(mv, x, seed, offset, carry):
    """The move's proposal as it ran before K19 (its draws and the JAX
    formula's ``gaussian_step``)."""
    nw, nd = x.shape
    scale, chol = mv._tensors("cpu", x.dtype)
    dims = None
    if mv.mode == "random":
        u = word_uniforms(nw, 1, 0, seed, offset, "cpu")[:, 0]
        dims = torch.clamp((u * nd).to(torch.int64), max=nd - 1)
    f = 1.0
    if mv._log_factor is not None:
        lf = mv._log_factor
        u = roll_uniforms(seed, 0, offset, "cpu")[0]
        f = torch.exp(-lf + u * (2.0 * lf))
    if "log_adj" in carry:
        f = f * torch.exp(carry["log_adj"])
    z = normals(nw, nd, seed, offset, "cpu")
    if mv.mode == "sequential":
        dims = carry["index"] % nd
    return gaussian_step(x, z, scale, chol, f, mv.mode, dims)


@pytest.mark.parametrize("kind,mode", CASES)
@pytest.mark.parametrize("factor", [None, 3.0])
@pytest.mark.parametrize("tuned", [False, True])
def test_stream_route_equals_the_old_step(kind, mode, factor, tuned):
    """The move's proposal on K19's plain version against the draws and
    step it used before: bit for bit, except the full covariance's sum
    order (1e-6)."""
    rng = np.random.default_rng(
        seed_of((kind, mode, factor, tuned, 1)) % 2**31)
    nd = 5
    mv = moves.GaussianMove(make_cov(kind, nd, rng), mode=mode, factor=factor,
                            tune_target=0.3 if tuned else None)
    x = torch.from_numpy(rng.normal(size=(NW, nd)).astype(np.float32))
    carry = mv.init_carry(NW, nd)
    if tuned:
        carry["log_adj"].fill_(0.4)
    if mode == "sequential":
        carry["index"].fill_(3)
    for offset in (0, 17):
        want = old_route(mv, x, 41, offset, carry)
        q, f, out = mv.get_proposal((41, offset), x, carry)
        assert out is carry and not f.any()
        if kind == "full":
            np.testing.assert_allclose(q.numpy(), want.numpy(), 1e-6, 1e-6)
        else:
            assert torch.equal(q, want)
    if mode == "sequential":
        assert int(carry["index"]) == 0


@pytest.mark.parametrize("kind,mode", CASES)
@pytest.mark.parametrize("draws", ["injected", "stream", "device word"])
def test_rung_axis_equals_each_rung_alone(kind, mode, draws):
    """Bit for bit: each rung of a rung-axis proposal is the one-ensemble
    plain version of that rung under ``keys.seeds[r]``, with its own
    ``log_adj`` and ``index`` (advanced, each rung's own), the scale
    shared; a factor on."""
    gen = torch.Generator().manual_seed(seed_of((kind, mode, draws)) % 2**31)
    rng = np.random.default_rng(5)
    T, nw, nd = 4, 10, 3
    mv = moves.GaussianMove(make_cov(kind, nd, rng), mode=mode, factor=2.0)
    scale, chol = mv._tensors("cpu", torch.float32)
    keys = rung_keys(77, T, "cpu")
    x = torch.randn(T, nw, nd, generator=gen)
    log_adj = 0.3 * torch.randn(T, generator=gen)
    index = torch.tensor([0, 2, 5, -1], dtype=torch.int32)
    offset = (DeviceOffset(torch.tensor(5, dtype=torch.int64), 4)
              if draws == "device word" else 9)
    inj = {}
    if draws == "injected":
        inj = dict(z=torch.randn(T, nw, nd, generator=gen),
                   u=torch.rand(T, generator=gen))
        if mode == "random":
            inj["dims"] = torch.randint(0, nd, (T, nw), generator=gen)
    idx = index.clone()
    q, f = gk.gaussian_propose(x, scale, chol, keys, offset, mode,
                               mv._log_factor, log_adj, idx, **inj)
    for r in range(T):
        idx_r = index[r].clone()
        qr, fr = gk.gaussian_propose(
            x[r], scale, chol, keys.seeds[r], 9, mode, mv._log_factor,
            log_adj[r], idx_r, **{k: v[r] for k, v in inj.items()})
        assert torch.equal(qr, q[r]) and torch.equal(fr, f[r]), r
        if mode == "sequential":
            assert int(idx[r]) == int(idx_r) == (int(index[r]) + 1) % nd
    if draws != "injected":  # the rungs draw apart
        assert not torch.equal(q[0] - x[0], q[1] - x[1])
