"""K16 and K17, the shuffled split's order and rows
(``emcee_tpu_torch/ops/shuffle_kernel.py``), on the CPU.

* The plain K16 equals the order the port took before the kernel
  (``torch.argsort(stable=True)`` of word 3, the transpose and each rung's
  base) bit for bit, through ``shuffled_order`` and ``rung_shuffled_order``:
  1-5 rungs, odd split sizes, ``nsplits`` 1-4; and a numpy stable argsort
  on injected keys with ties (all equal, two values, sorted, reversed).
* The kernels' algorithms, replayed in numpy step by step as the CUDA
  sources run them (``csrc/shuffle_order.cu``: the ranks by count, the
  bitonic network of a block, the merge passes and the order's write; ``csrc/gather_rows.cu``:
  the descriptors' blocks, the unit index's magic division and the unit
  copies), equal the plain versions: the kernels cannot run here, so
  their index arithmetic is held here and their bits on the card
  (``chip_smoke.py`` phase 20).
* The plain gather and scatter equal ``index_select`` / ``index_copy_``
  for every blob dtype and row shape, through the wrappers.
* ``shuffle_plan`` (hypothesis): every walker of a segment in exactly one
  chunk, the route by length, the launches, threads and shared memory
  within the block's limits; ``rows_plan``: every unit of every buffer in
  exactly one thread, launches of ``ROWS_CAPACITY`` buffers.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

torch.set_num_threads(1)

from emcee_tpu_torch.moves.red_blue import rung_shuffled_order, shuffled_order
from emcee_tpu_torch.ops import philox
from emcee_tpu_torch.ops import shuffle_kernel as shk
from emcee_tpu_torch.ops._wrap import divisor
from emcee_tpu_torch.ops.accept_kernel import blob_unit

SEED = 0x1234_5678_9ABC


def old_order(seed, nw, nsplits, offset):
    """The shuffled split's order as the port computed it before K16."""
    lo, hi = philox.split_offset(offset)
    w3 = philox.philox4x32(torch.arange(nw, dtype=torch.int64), nsplits,
                           lo, hi, philox.split_key(seed))[3]
    perm = torch.argsort(w3, stable=True)
    return perm.view(nw // nsplits, nsplits).t().reshape(-1)


def np_order(keys, nsplits):
    """Numpy's stable argsort of each row of ``keys``, grouped: the
    definition K16 computes."""
    T, n = keys.shape
    perm = np.argsort(keys, axis=1, kind="stable")
    order = perm.reshape(T, n // nsplits, nsplits).transpose(0, 2, 1)
    return (order.reshape(T, n) + np.arange(T)[:, None] * n).reshape(-1)


def tied_keys(kind, T, n, rng):
    if kind == "equal":
        k = np.full((T, n), 7)
    elif kind == "two values":
        k = rng.integers(0, 2, (T, n)) * (2**32 - 1)
    elif kind == "sorted":
        k = np.sort(rng.integers(0, 5, (T, n)), axis=1)
    elif kind == "reversed":
        k = np.sort(rng.integers(0, 5, (T, n)), axis=1)[:, ::-1]
    else:
        k = rng.integers(0, 2**32, (T, n))
    return np.array(k.tolist(), dtype=np.int64).reshape(T, n)


@pytest.mark.parametrize("nsplits", [1, 2, 3, 4])
@pytest.mark.parametrize("ng", [1, 7, 33])
def test_plain_order_equals_the_route_before_k16(nsplits, ng):
    nw = nsplits * ng
    for offset in (0, 17):
        assert torch.equal(shuffled_order((SEED, offset), nw, nsplits, "cpu"),
                           old_order(SEED, nw, nsplits, offset))
        for T in (1, 2, 3, 5):
            keys = philox.rung_keys(SEED, T, "cpu")
            got = rung_shuffled_order((keys, offset), T, nw, nsplits, "cpu")
            want = torch.cat([old_order(s, nw, nsplits, offset) + r * nw
                              for r, s in enumerate(keys.seeds)])
            assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["equal", "two values", "sorted",
                                  "reversed", "random"])
@pytest.mark.parametrize("T,n,nsplits", [(1, 6, 2), (3, 15, 3), (5, 64, 4),
                                         (2, 4099, 1)])
def test_plain_order_is_stable_on_tied_keys(kind, T, n, nsplits):
    keys = tied_keys(kind, T, n, np.random.default_rng(n + T))
    got = shk.group_order(torch.from_numpy(keys), nsplits)
    assert got.dtype == torch.int64 and got.shape == (T * n,)
    np.testing.assert_array_equal(got.numpy(), np_order(keys, nsplits))
    if T == 1:  # one ensemble's (n,) keys
        one = shk.group_order(torch.from_numpy(keys[0]), nsplits)
        np.testing.assert_array_equal(one.numpy(), got.numpy())
    out = torch.empty(T * n, dtype=torch.int64)
    assert shk.group_order(torch.from_numpy(keys), nsplits, out=out) is out
    np.testing.assert_array_equal(out.numpy(), got.numpy())


# -- the kernels' algorithms, in numpy ---------------------------------------

PAD = np.uint64(2**64 - 1)


def bitonic(s):
    """``group_order_kernel``'s network over one block's words ``s`` (a
    power of two of them), stage by stage as the block runs it."""
    chunk = s.shape[0]
    t = np.arange(chunk // 2)
    size = 2
    while size <= chunk:
        stride = size >> 1
        while stride > 0:
            lo = 2 * t - (t & (stride - 1))
            hi = lo + stride
            a, b = s[lo].copy(), s[hi].copy()
            swap = (a > b) == ((lo & size) == 0)
            s[lo[swap]], s[hi[swap]] = b[swap], a[swap]
            stride >>= 1
        size <<= 1
    return s


def write_order(order, r, n, nsplits, p, w):
    ng = n // nsplits
    i, j = p // nsplits, p % nsplits
    order[r * n + j * ng + i] = r * n + (w & np.uint64(0xFFFFFFFF)).astype(
        np.int64)


def emulate_group_order(keys, nsplits, plan):
    """K16 as ``emcee_group_order`` launches it with ``plan``."""
    T, n = keys.shape
    order = np.full(T * n, -1, np.int64)
    for r in range(T):
        words = ((keys[r].astype(np.uint64) << np.uint64(32))
                 | np.arange(n, dtype=np.uint64))
        if plan.route == "rank":
            for b in range(plan.chunks):  # a thread a word: its rank
                e = np.arange(b * plan.threads,
                              min((b + 1) * plan.threads, n))
                p = (words[None, :] < words[e, None]).sum(axis=1)
                write_order(order, r, n, nsplits, p, words[e])
            continue
        if plan.route == "short":
            s = np.full(plan.chunk, PAD)
            s[:n] = words
            s = bitonic(s)
            write_order(order, r, n, nsplits, np.arange(n), s[:n])
            continue
        seg = np.empty(n, np.uint64)
        for c in range(plan.chunks):
            c0 = c * plan.chunk
            ln = min(plan.chunk, n - c0)
            s = np.full(plan.chunk, PAD)
            s[:ln] = words[c0:c0 + ln]
            seg[c0:c0 + ln] = bitonic(s)[:ln]
        run, ways = plan.chunk, 2  # merged pairwise
        for m in range(plan.merges):
            e = np.arange(n)
            g0 = e - e % (ways * run)
            mine = (e - g0) // run
            p = e - mine * run
            for q in range(ways):  # each sibling run's words below
                b0 = np.minimum(g0 + q * run, n)
                b1 = np.minimum(g0 + (q + 1) * run, n)
                for lo, hi in set(zip(b0.tolist(), b1.tolist())):
                    at = (b0 == lo) & (mine != q)
                    p[at] += np.searchsorted(seg[lo:hi], seg[at], "left")
            assert np.array_equal(np.sort(p), np.arange(n))
            if m + 1 == plan.merges:
                write_order(order, r, n, nsplits, p, seg)
            else:
                nxt = np.empty_like(seg)
                nxt[p] = seg
                seg = nxt
            run *= ways
    return order


@pytest.mark.parametrize("kind", ["equal", "two values", "sorted",
                                  "reversed", "random"])
@pytest.mark.parametrize("T,n,nsplits,chunk", [
    (16, 256, 2, None), (3, 15, 3, None), (2, 2, 2, None), (1, 1, 1, None),
    (2, 2048, 4, None), (1, 3000, 2, None), (2, 300, 3, 512), (2, 37, 1, 4),
    (1, 100, 4, 8), (3, 96, 2, 32), (1, 5003, 1, None), (2, 9000, 3, None),
    (1, 20_000, 2, None), (2, 1000, 2, 16)])
def test_k16_algorithm_equals_the_plain_order(kind, T, n, nsplits, chunk):
    keys = tied_keys(kind, T, n, np.random.default_rng(3 * n + T))
    plan = shk.shuffle_plan(T, n, nsplits, 132, chunk=chunk)
    want = shk.group_order_plain(torch.from_numpy(keys), nsplits).numpy()
    np.testing.assert_array_equal(emulate_group_order(keys, nsplits, plan),
                                  want)


def emulate_copy_rows(order, bufs, descs, blocks, scatter):
    """K17 as ``emcee_copy_rows`` launches it: each launch's blocks find
    their buffer by ``first_block``, each thread its unit by the magic
    division, and copies one unit (the buffers are numpy byte views)."""
    covered = [np.zeros(d[7], np.int64) for d in descs]
    for g, nblk in enumerate(blocks):
        group = list(range(g * shk.ROWS_CAPACITY,
                           min((g + 1) * shk.ROWS_CAPACITY, len(descs))))
        for blk in range(nblk):
            b = [i for i in group if descs[i][6] <= blk][-1]
            src, dst = bufs[b]
            _, _, row, unit, mul, shr, first, units = descs[b]
            t = (blk - first) * shk.ROWS_THREADS + np.arange(
                shk.ROWS_THREADS, dtype=np.uint64)
            t = t[t < units]
            k = t if mul == 0 else ((t * np.uint64(mul)) >> np.uint64(32)
                                    ) >> np.uint64(shr)
            upr = row // unit
            c = (t - k * np.uint64(upr)).astype(np.int64)
            k = k.astype(np.int64)
            o = order[k]
            frm, to = (k, o) if scatter else (o, k)
            for byte in range(unit):
                dst[(to * upr + c) * unit + byte] = src[(frm * upr + c) * unit
                                                        + byte]
            covered[b][t.astype(np.int64)] += 1
    assert all((c == 1).all() for c in covered)


BLOBS = [(torch.float32, ()), (torch.float64, (3,)), (torch.int64, ()),
         (torch.int32, (2, 5)), (torch.int16, (3,)), (torch.int8, (7,)),
         (torch.bool, ()), (torch.float32, (129,))]


def as_bytes(t):
    return t.contiguous().view(torch.uint8).reshape(-1).numpy()


@pytest.mark.parametrize("scatter", [False, True])
@pytest.mark.parametrize("misalign", [0, 1, 2, 4, 8])
def test_k17_algorithm_equals_index_select_and_index_copy(scatter, misalign):
    """Every blob dtype and row shape, NaN rows included, at bases
    ``misalign`` bytes (source) and ``16 - misalign`` bytes (destination)
    past a 16-byte boundary on every other buffer: the unit each buffer
    takes follows from them, as the wrapper picks it from the pointers."""
    gen = torch.Generator().manual_seed(misalign + 10 * scatter)
    rows = 37
    order = torch.randperm(rows, generator=gen)
    srcs = []
    for dt, row in BLOBS:
        x = torch.randn((rows, *row), generator=gen).mul(100)
        srcs.append(x.to(dt) if dt != torch.bool else x > 0)
    srcs[0][3] = torch.nan  # a NaN row moves as its bytes
    bufs, ptrs, wants = [], [], []
    for i, s in enumerate(srcs):
        ms = misalign * (i % 2)
        md = (16 - ms) % 16
        sb = as_bytes(s)
        src = np.zeros(sb.size + 16, np.uint8)
        src[ms:ms + sb.size] = sb
        dst = np.zeros(sb.size + 16, np.uint8)
        bufs.append((src[ms:], dst[md:]))
        ptrs.append((4096 + ms, 8192 + md, s[0].numel() * s.element_size()))
        wants.append(torch.zeros_like(s).index_copy_(0, order, s) if scatter
                     else s.index_select(0, order))
    descs, blocks = shk.rows_plan(rows, ptrs)
    assert [d[3] for d in descs] == [blob_unit(*p) for p in ptrs]
    emulate_copy_rows(order.numpy(), bufs, descs, blocks, scatter)
    for (_, dst), want in zip(bufs, wants):
        wb = as_bytes(want)
        np.testing.assert_array_equal(dst[:wb.size], wb)


@pytest.mark.parametrize("dtype,row", BLOBS)
def test_plain_gather_and_scatter_are_index_select_and_index_copy(dtype,
                                                                  row):
    gen = torch.Generator().manual_seed(len(row) + dtype.itemsize)
    T, nw, ns = 3, 12, 2
    x = torch.randn((T, nw, *row), generator=gen).mul(50)
    x = x.to(dtype) if dtype != torch.bool else x > 0
    flat = x.view(T * nw, *row)
    keys = philox.rung_keys(SEED, T, "cpu")
    order = rung_shuffled_order((keys, 3), T, nw, ns, "cpu")
    lp = torch.randn(T * nw, generator=gen)
    got = shk.gather_rows(order, [flat, lp])
    assert torch.equal(got[0], flat.index_select(0, order))
    assert torch.equal(got[1], lp.index_select(0, order))
    outs = [torch.empty_like(flat), torch.empty_like(lp)]
    assert shk.gather_rows(order, [flat, lp], outs)[0] is outs[0]
    assert torch.equal(outs[0], got[0]) and torch.equal(outs[1], got[1])
    back = [torch.zeros_like(flat), torch.zeros_like(lp)]
    shk.scatter_rows(order, back, got)
    assert torch.equal(back[0], flat) and torch.equal(back[1], lp)
    want = torch.zeros_like(flat).index_copy_(0, order, got[0])
    assert torch.equal(back[0], want)


def test_wrappers_raise_on_other_devices():
    counts = [(f.launches, f.device_launches)
              for f in (shk.group_order, shk.gather_rows, shk.scatter_rows)]
    order = shk.group_order(torch.arange(8, dtype=torch.int64), 2)
    shk.scatter_rows(order, [torch.zeros(8)],
                     shk.gather_rows(order, [torch.ones(8)]))
    assert counts == [(f.launches, f.device_launches) for f in (
        shk.group_order, shk.gather_rows, shk.scatter_rows)] == [(0, None)] * 3
    meta = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no K16 kernel"):
        shk.group_order(meta, 2)
    with pytest.raises(ValueError, match="no K17 kernel"):
        shk.gather_rows(meta, [meta])
    with pytest.raises(ValueError, match="no K17 kernel"):
        shk.scatter_rows(meta, [meta], [meta])
    with pytest.raises(ValueError, match="power of two"):
        shk.shuffle_plan(1, 100, 2, 132, chunk=48)
    with pytest.raises(ValueError, match="bad segments"):
        shk.shuffle_plan(1, 9, 2, 132)


@settings(max_examples=200, deadline=None)
@given(T=st.integers(1, 64), n_per=st.integers(1, 60_000),
       ns=st.integers(1, 4), n_sm=st.sampled_from([1, 78, 132, 144]),
       force=st.sampled_from([None, 2, 64, 1024, 4096]))
def test_shuffle_plan_covers_every_walker_once(T, n_per, ns, n_sm, force):
    n = n_per * ns
    plan = shk.shuffle_plan(T, n, ns, n_sm, chunk=force)
    if force is None and n <= shk.RANK_MAX:
        assert plan == (
            "rank", 0, shk.RANK_THREADS, -(-n // shk.RANK_THREADS), 0,
            8 * shk.RANK_MAX)
        assert (plan.chunks - 1) * plan.threads < n <= (
            plan.chunks * plan.threads)
        assert plan.launches == 1 and plan.smem <= shk.SMEM_LIMIT
        return
    chunk = plan.chunk
    assert chunk & (chunk - 1) == 0 and 2 <= chunk <= shk.CHUNK_MAX
    assert (plan.chunks - 1) * chunk < n <= plan.chunks * chunk
    assert plan.route == ("short" if chunk >= n else "long")
    if force is None:
        assert plan.route == ("short" if n <= shk.CHUNK_MAX else "long")
        assert n > shk.RANK_MAX
        if plan.route == "short":
            assert chunk // 2 < max(n, 2) <= chunk
        else:
            assert chunk >= shk.MERGE_CHUNK_MIN
            assert (chunk == shk.MERGE_CHUNK_MIN
                    or T * plan.chunks >= n_sm)
    assert plan.launches == 1 + plan.merges
    ways = 2
    assert ways**plan.merges >= plan.chunks > ways ** (plan.merges - 1) or (
        plan.chunks == 1 and plan.merges == 0)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.threads <= max(32, chunk // 2)
    assert plan.smem == 8 * chunk <= shk.SMEM_LIMIT


@settings(max_examples=200, deadline=None)
@given(rows=st.integers(1, 200_000),
       bufs=st.lists(st.tuples(st.integers(0, 15), st.integers(0, 15),
                               st.integers(1, 600)), min_size=1,
                     max_size=70))
def test_rows_plan_covers_every_unit_once(rows, bufs):
    bufs = [(4096 + a, 8192 + b, row) for a, b, row in bufs
            if rows * row < 2**31]
    if not bufs:
        return
    descs, blocks = shk.rows_plan(rows, bufs)
    assert len(blocks) == -(-len(bufs) // shk.ROWS_CAPACITY)
    for i, ((src, dst, row), d) in enumerate(zip(bufs, descs)):
        _, _, row_b, unit, mul, shr, first, units = d
        assert unit == blob_unit(src, dst, row) and row % unit == 0
        assert src % unit == 0 and dst % unit == 0
        assert units == rows * (row // unit)
        assert (mul, shr) == divisor(row // unit)
        g = i // shk.ROWS_CAPACITY
        nxt = (descs[i + 1][6] if (i + 1) // shk.ROWS_CAPACITY == g
               and i + 1 < len(descs) else blocks[g])
        assert i % shk.ROWS_CAPACITY or first == 0
        assert nxt - first == -(-units // shk.ROWS_THREADS)
        # The last unit's row by the magic division.
        t = units - 1
        k = t if mul == 0 else ((t * mul) >> 32) >> shr
        assert k == t // (row // unit) == rows - 1
