"""The port's Philox4x32-10 stream against a scalar reference and
Random123's known-answer vectors."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu_torch.ops import philox

# Random123 kat_vectors, philox4x32_10: (counter, key, expected words).
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,expected", KAT)
def test_known_answers(counter, key, expected):
    assert tuple(philox.philox4x32_scalar(counter, key)) == expected
    c = [torch.tensor([w], dtype=torch.int64) for w in counter]
    for fn in (philox.philox4x32_torch, philox.philox4x32):
        got = tuple(int(np.asarray(w)[0]) for w in fn(*c, key))
        assert got == expected, fn.__name__


# Counters whose first-round products overflow int64 (M * c >= 2**63 for
# both multiplied words), with their scalar answers: the wrapped int64
# product must give the same words as Python's exact one.
OVERFLOW = [(0xFFFFFFFF, 0, 0xFFFFFFFF, 0), (0x9E3779B9, 1, 0xF0000001, 2),
            (0xC0000000, 7, 0xA0000000, 0xFFFFFFFF)]


@pytest.mark.parametrize("counter", OVERFLOW)
def test_known_answers_where_products_overflow(counter):
    key = (0xDEADBEEF, 0x12345678)
    assert philox._M0 * counter[0] >= 2**63
    assert philox._M1 * counter[2] >= 2**63
    ref = philox.philox4x32_scalar(counter, key)
    c = [torch.tensor([w], dtype=torch.int64) for w in counter]
    for got in (philox.philox4x32_torch(*c, key),
                philox.philox4x32(c[0], *counter[1:], key)):
        assert [int(np.asarray(w)[0]) for w in got] == ref


def test_cpu_draw_sharing_gives_fresh_words():
    """On the CPU, walker_words and roll_uniforms share one draw per
    (split, seed, offset); whatever the order of the calls, every word
    equals the scalar reference."""
    from emcee_tpu_torch.ops.philox import DeviceOffset

    seed, split = 987654321, 1
    key = philox.split_key(seed)
    for offset in (5, DeviceOffset(torch.tensor(2**32 + 3), 4)):
        value = 5 if isinstance(offset, int) else 2**32 + 7
        lo, hi = value & philox.MASK32, value >> 32
        calls = (
            (9, split), (9, split | philox.PAIR_BLOCK), (9, split),
            (4, split), (4, split | philox.PAIR_BLOCK), (9, split + 1))
        for n, blk in calls:
            words = philox.walker_words(n, blk, seed, offset, "cpu")
            for i in range(n):
                assert [int(w[i]) for w in words] == \
                    philox.philox4x32_scalar((i, blk, lo, hi), key)
            u = philox.roll_uniforms(seed, blk & ~philox.PAIR_BLOCK, offset,
                                     "cpu")
            w = philox.philox4x32_scalar(
                (philox.ROLL_LANE, blk & ~philox.PAIR_BLOCK, lo, hi), key)
            assert u.tolist() == [(x >> 8) * 2.0**-24 for x in w]


def test_cpu_draws_of_two_threads_stay_their_own():
    """Two threads drawing walker words of different seeds at the same
    time each get their own stream's words (each thread keeps its own
    last draw)."""
    import sys
    import threading

    n, offsets = 8, range(150)
    lanes = torch.arange(n, dtype=torch.int64)
    want = {seed: [philox.philox4x32(lanes, 0, off, 0, philox.split_key(seed))
                   for off in offsets] for seed in (11, 22)}
    start = threading.Barrier(2)
    bad = []

    def draw(seed):
        start.wait()
        for off in offsets:
            for _ in range(2):  # the second call reads the kept draw
                got = philox.walker_words(n, 0, seed, off, "cpu")
                if not all(torch.equal(a, b)
                           for a, b in zip(got, want[seed][off])):
                    bad.append((seed, off))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=draw, args=(s,)) for s in want]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    assert bad == []


@pytest.mark.parametrize("n,d,row0", [(5, 3, 0), (4, 8, 6), (3, 1, 2)])
def test_row_draws_match_scalar(n, d, row0):
    seed, offset = 31337, 2**33 + 1
    lo, hi = philox.split_offset(offset)
    key = philox.split_key(seed)
    z = philox.normals(n, d, seed, offset, "cpu", row0=row0)
    u = philox.row_uniforms(n, d, seed, offset, "cpu", row0=row0)
    assert z.shape == u.shape == (n, d)
    for r in range(n):
        for j in range(d):
            w = philox.philox4x32_scalar(
                (row0 + r, philox.NORMAL_BLOCK | (j // 2), lo, hi), key)
            a, b = (w[0], w[2]) if j % 2 == 0 else (w[1], w[3])
            want = philox.box_muller(torch.tensor(a), torch.tensor(b))
            assert float(z[r, j]) == float(want)
            w = philox.philox4x32_scalar(
                (row0 + r, philox.PICK_BLOCK | (j // 4), lo, hi), key)
            assert float(u[r, j]) == (w[j % 4] >> 8) * 2.0**-24


@pytest.mark.parametrize("impl", ["torch", "dispatch"])
def test_matches_scalar_on_random_counters(impl):
    rng = np.random.default_rng(7)
    n = 64
    ctr = rng.integers(0, 2**32, size=(4, n), dtype=np.uint64).astype(np.int64)
    key = tuple(int(k) for k in rng.integers(0, 2**32, size=2))
    fn = {"torch": philox.philox4x32_torch,
          "dispatch": philox.philox4x32}[impl]
    out = fn(*(torch.from_numpy(c) for c in ctr), key)
    out = np.stack([np.asarray(w, dtype=np.int64) for w in out])
    for j in range(n):
        ref = philox.philox4x32_scalar(ctr[:, j], key)
        assert list(out[:, j]) == ref


@pytest.mark.parametrize("split,offset", [(0, 0), (3, 2**32 + 5)])
def test_walker_words_match_scalar(split, offset):
    seed = 0xDEADBEEF12345
    words = philox.walker_words(17, split, seed, offset, device="cpu")
    lo, hi = philox.split_offset(offset)
    for i in range(17):
        ref = philox.philox4x32_scalar((i, split, lo, hi),
                                       philox.split_key(seed))
        assert [int(w[i]) for w in words] == ref


def test_uniforms_in_unit_interval_and_exact_in_f32():
    words = torch.tensor([0, 1, 255, 256, 2**31, 2**32 - 1],
                         dtype=torch.int64)
    u = philox.to_uniform(words)
    assert u.dtype == torch.float32
    assert float(u.min()) == 0.0 and float(u.max()) < 1.0
    assert float(u[-1]) == 1.0 - 2.0**-24
    w = philox.walker_words(4096, 1, seed=11, offset=5, device="cpu")
    for word in w:
        x = philox.to_uniform(word)
        assert 0.0 <= float(x.min()) and float(x.max()) < 1.0
        # 24 bits: every value is k * 2**-24 exactly.
        k = x.double() * 2.0**24
        assert torch.equal(k, torch.round(k))
        assert 0.4 < float(x.mean()) < 0.6


def test_distinct_streams_for_distinct_split_offset_seed():
    base = philox.walker_words(256, 0, seed=1, offset=0, device="cpu")[0]
    for split, offset, seed in [(1, 0, 1), (0, 1, 1), (0, 2**32, 1),
                                (0, 0, 2), (0, 0, 2**32 + 1)]:
        other = philox.walker_words(256, split, seed, offset, "cpu")[0]
        assert (base != other).float().mean() > 0.99
    again = philox.walker_words(256, 0, seed=1, offset=0, device="cpu")[0]
    assert torch.equal(base, again)


def test_host_uniforms_match_the_stream():
    seed, offset, split = 123456789012, 2**32 + 17, 1
    lo, hi = philox.split_offset(offset)
    w = philox.philox4x32_scalar((philox.ROLL_LANE, split, lo, hi),
                                 philox.split_key(seed))
    u = philox.uniform_scalar(seed, philox.ROLL_LANE, split, offset)
    assert u == (w[0] >> 8) * 2.0**-24
    for nc in (1, 7, 50_000, 2**24 - 1):
        shift = philox.roll_shift(seed, split, offset, nc)
        assert shift == int(np.float32(u) * np.float32(nc))
        assert 0 <= shift <= nc
