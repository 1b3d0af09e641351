"""K14, the counter-based Philox draws (``ops/philox_kernel.py``), on the
CPU.

A CPU call takes the plain version (the torch rounds), so here every
kind of draw is held against the plain functions of ``ops/philox.py`` and
the scalar reference, exactly: the words, one word, uniforms and normals
in float32 and float64, the rung axis with and without the ROLL_LANE
column, a block given as a 0-d tensor, a device offset word and a lane
offset ``row0``.  The kernel itself is held against the same plain
version on the card (``chip_smoke.py`` phase 16).  The JAX package draws
from threefry keys, whose bits the port cannot reproduce, so against JAX
the draws are compared in distribution (two-sample K-S) on the same
sizes.
"""

import jax
import numpy as np
import pytest
import torch
from scipy import stats

torch.set_num_threads(1)

from emcee_tpu_torch.moves.red_blue import (
    rung_shuffled_order, shuffled_order)
from emcee_tpu_torch.ops import philox
from emcee_tpu_torch.ops import philox_kernel as pk
from emcee_tpu_torch.ops.philox import DeviceOffset

SEED = 0x0123456789ABCDEF


def scalar_words(rows, cols, offset, seed=SEED):
    """Every counter's four words by ``philox4x32_scalar``: ``(4, len(rows),
    len(cols))`` int64."""
    lo, hi = philox.split_offset(offset)
    key = philox.split_key(seed)
    out = np.zeros((4, len(rows), len(cols)), np.int64)
    for i, r in enumerate(rows):
        for j, c in enumerate(cols):
            out[:, i, j] = philox.philox4x32_scalar((r, c, lo, hi), key)
    return torch.from_numpy(out)


@pytest.mark.parametrize("n,k,row0", [(1, 1, 0), (7, 3, 0), (31, 5, 12),
                                      (4, 17, (1 << 32) - 4)])
def test_words_equal_row_words_and_the_scalar_reference(n, k, row0):
    block = philox.DEZ_BLOCK
    got = pk.philox_draw("words", n, k, block, SEED, 9, "cpu", row0=row0)
    want = philox.row_words(n, k, block, SEED, 9, "cpu", row0=row0)
    ref = scalar_words(range(row0, row0 + n), range(block, block + k), 9)
    assert len(got) == 4
    for w in range(4):
        assert torch.equal(got[w], want[w])
        assert torch.equal(got[w], ref[w])
        one = pk.philox_draw("words", n, k, block, SEED, 9, "cpu",
                             row0=row0, word=w)
        assert torch.equal(one, ref[w])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,d,row0", [(1, 1, 0), (9, 4, 3), (33, 7, 0),
                                      (5, 17, 100)])
def test_uniforms_and_normals_equal_the_plain_functions(dtype, n, d, row0):
    u = pk.philox_draw("uniforms", n, None, philox.PICK_BLOCK, SEED, 4,
                       "cpu", row0=row0, d=d, dtype=dtype)
    assert u.dtype == dtype and u.shape == (n, d)
    assert torch.equal(u, philox.row_uniforms(n, d, SEED, 4, "cpu", dtype,
                                              row0))
    z = pk.philox_draw("normals", n, None, philox.NORMAL_BLOCK, SEED, 4,
                       "cpu", row0=row0, d=d, dtype=dtype)
    assert z.dtype == dtype and z.shape == (n, d)
    assert torch.equal(z, philox.normals(n, d, SEED, 4, "cpu", dtype, row0))
    # Uniforms of one word: (n, k) of that word alone.
    for w in (0, 3):
        one = pk.philox_draw("uniforms", n, 3, philox.SLICE_BLOCK, SEED, 4,
                             "cpu", row0=row0, word=w, dtype=dtype)
        words = philox.row_words(n, 3, philox.SLICE_BLOCK, SEED, 4, "cpu",
                                 row0)
        assert torch.equal(one, philox.to_uniform(words[w], dtype))
        assert torch.equal(one, philox.word_uniforms(
            n, 3, philox.SLICE_BLOCK, SEED, 4, "cpu", w, dtype, row0))


@pytest.mark.parametrize("roll", [False, True])
@pytest.mark.parametrize("T", [1, 3, 16])
def test_rung_axis_equals_rung_words_and_each_rungs_walker_words(T, roll):
    keys = philox.rung_keys(SEED, T, "cpu")
    got = pk.philox_draw("words", 11, 1, 2, keys, 13, "cpu", roll=roll)
    want = philox.rung_words(keys, 11, 2, 13, "cpu", roll=roll)
    for w in range(4):
        assert got[w].shape == (T, 11 + roll, 1)
        assert torch.equal(got[w][..., 0], want[w])
        for r, s in enumerate(keys.seeds):
            lanes = list(range(11)) + [philox.ROLL_LANE] * roll
            ref = scalar_words(lanes, [2], 13, s)[w, :, 0]
            assert torch.equal(got[w][r, :, 0], ref)
    three = pk.philox_draw("words", 11, 1, 2, keys, 13, "cpu", word=3,
                           roll=roll)
    assert torch.equal(three[..., 0], want[3])
    assert torch.equal(philox.rung_words(keys, 11, 2, 13, "cpu", roll=roll,
                                         word=3), want[3])


def test_block_tensor_device_offset_and_the_launch_count():
    """A 0-d block tensor draws what its int draws, a DeviceOffset what
    its value draws, and a CPU call launches nothing."""
    before = pk.philox_draw.launches
    block = philox.SHRINK_BLOCK | 5
    off = DeviceOffset(torch.tensor(2**32 + 3), 4)
    for kind, kw in (("words", dict(word=0)), ("uniforms", dict(d=6)),
                     ("normals", dict(d=5, dtype=torch.float64))):
        k = 2 if kind == "words" else None
        a = pk.philox_draw(kind, 9, k, torch.tensor(block), SEED, off,
                           "cpu", **kw)
        b = pk.philox_draw(kind, 9, k, block, SEED, 2**32 + 7, "cpu", **kw)
        assert torch.equal(a, b)
    assert torch.equal(
        philox.word_uniforms(9, 4, philox.SHRINK_BLOCK | torch.tensor(5),
                             SEED, off, "cpu"),
        philox.to_uniform(philox.row_words(9, 4, block, SEED, 2**32 + 7,
                                           "cpu")[0]))
    assert pk.philox_draw.launches == before
    assert pk.philox_draw.device_launches is None


def test_public_draws_keep_their_values():
    """The draws that go through K14 on the card give, on the CPU, the
    values of the formulas they replace."""
    lo, hi = philox.split_offset(21)
    key = philox.split_key(SEED)
    lanes = torch.arange(50, dtype=torch.int64)
    w = philox.philox4x32(lanes, 1, lo, hi, key)
    assert torch.equal(philox.walker_words(50, 1, SEED, 21, "cpu", word=2),
                       w[2])
    assert torch.equal(
        philox.word_uniforms(50, 1, 1, SEED, 21, "cpu", 1)[:, 0],
        philox.to_uniform(w[1]))
    roll = philox.philox4x32(torch.tensor(philox.ROLL_LANE),
                             philox.GRAD_BLOCK | 1, lo, hi, key)[0]
    assert torch.equal(philox.grad_uniform(SEED, 1, 21, "cpu"),
                       philox.to_uniform(roll))
    blend = philox.philox4x32(torch.tensor(philox.ROLL_LANE),
                              philox.BLEND_BLOCK | torch.arange(3), lo, hi,
                              key)[0]
    assert torch.equal(philox.word_uniforms(1, 3, philox.BLEND_BLOCK, SEED,
                                            21, "cpu",
                                            row0=philox.ROLL_LANE)[0],
                       philox.to_uniform(blend))
    for plain in (False, True):
        assert torch.equal(philox.normals(7, 3, SEED, 21, "cpu",
                                          plain=plain),
                           philox.normals(7, 3, SEED, 21, "cpu"))


@pytest.mark.parametrize("nsplits", [2, 3])
def test_shuffled_orders_equal_the_order_before_k14(nsplits):
    """The shuffled split's order from word 3 alone equals the order the
    four words gave before (one sort key a walker, a stable sort), on one
    ensemble and on every rung."""
    nw, offset = 48, 17

    def old_order(seed):
        lo, hi = philox.split_offset(offset)
        w3 = philox.philox4x32(torch.arange(nw, dtype=torch.int64), nsplits,
                               lo, hi, philox.split_key(seed))[3]
        perm = torch.argsort(w3, stable=True)
        return perm.view(nw // nsplits, nsplits).t().reshape(-1)

    assert torch.equal(shuffled_order((SEED, offset), nw, nsplits, "cpu"),
                       old_order(SEED))
    keys = philox.rung_keys(SEED, 4, "cpu")
    got = rung_shuffled_order((keys, offset), 4, nw, nsplits, "cpu")
    want = torch.cat([old_order(s) + r * nw
                      for r, s in enumerate(keys.seeds)])
    assert torch.equal(got, want)
    w3 = pk.philox_draw("words", nw, 1, nsplits, SEED, offset, "cpu",
                        word=3)[:, 0]
    perm = torch.argsort(w3, stable=True)
    assert torch.equal(perm.view(nw // nsplits, nsplits).t().reshape(-1),
                       old_order(SEED))


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="float32 or float64"):
        pk.philox_draw("normals", 4, None, 0, SEED, 0, "cpu", d=2,
                       dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or float64"):
        pk.philox_draw("uniforms", 4, 2, 0, SEED, 0, "cpu", word=1,
                       dtype=torch.int32)
    with pytest.raises(ValueError, match="0-d int64 tensor"):
        pk.philox_draw("words", 4, 2, torch.tensor(3, device="meta"), SEED,
                       0, "cpu")
    with pytest.raises(ValueError, match="0-d int64 tensor"):
        pk.philox_draw("words", 4, 2, torch.tensor([3]), SEED, 0, "cpu")
    with pytest.raises(ValueError, match="overflow the 32-bit block word"):
        pk.philox_draw("words", 4, 2, (1 << 32) - 1, SEED, 0, "cpu")
    with pytest.raises(ValueError, match="overflow the lane word"):
        pk.philox_draw("words", 5, 1, 0, SEED, 0, "cpu", row0=(1 << 32) - 4)
    with pytest.raises(ValueError, match="word must be 0-3"):
        pk.philox_draw("words", 4, 1, 0, SEED, 0, "cpu", word=4)
    with pytest.raises(ValueError, match="unknown kind"):
        pk.philox_draw("bits", 4, 1, 0, SEED, 0, "cpu")
    with pytest.raises(ValueError, match="no K14 kernel"):
        pk.philox_draw("words", 4, 1, 0, SEED, 0, "meta")


def test_draws_match_jax_random_in_distribution():
    """Same sizes through jax.random and K14's CPU route: two-sample K-S
    on standard normals and uniforms (fixed seeds; the streams differ)."""
    n = 20_000
    z = pk.philox_draw("normals", n // 4, None, philox.NORMAL_BLOCK, 5, 0,
                       "cpu", d=4).reshape(-1).numpy()
    u = pk.philox_draw("uniforms", n // 4, None, philox.PICK_BLOCK, 5, 0,
                       "cpu", d=4).reshape(-1).numpy()
    kz, ku = jax.random.split(jax.random.PRNGKey(5))
    zj = np.asarray(jax.random.normal(kz, (n,)))
    uj = np.asarray(jax.random.uniform(ku, (n,)))
    assert stats.ks_2samp(z, zj).pvalue > 1e-3
    assert stats.ks_2samp(u, uj).pvalue > 1e-3
    assert abs(z.mean()) < 0.03 and abs(z.std() - 1) < 0.03
