"""K16 and K17, the shuffled split's order and rows
(``emcee_tpu_torch/ops/shuffle_kernel.py``), on the CPU.

* The plain K16 equals the order the port took before the kernel
  (``torch.argsort(stable=True)`` of word 3, the transpose and each rung's
  base) bit for bit, through ``shuffled_order`` and ``rung_shuffled_order``:
  1-5 rungs, odd split sizes, ``nsplits`` 1-4; and a numpy stable argsort
  on injected keys with ties (all equal, two values, sorted, reversed).
* The kernels' algorithms, replayed in numpy step by step as the CUDA
  sources run them (``csrc/shuffle_order.cu``: the ranks by count, the
  radix route's histogram blocks, each pass's warp ranks by digit,
  look-back prefixes and scatter, and the order's write; ``csrc/gather_rows.cu``:
  the descriptors' blocks, the unit index's magic division and the unit
  copies), equal the plain versions: the kernels cannot run here, so
  their index arithmetic is held here and their bits on the card
  (``chip_smoke.py`` phase 20).
* The plain gather and scatter equal ``index_select`` / ``index_copy_``
  for every blob dtype and row shape, through the wrappers.
* ``shuffle_plan`` (hypothesis): every walker of a segment in exactly one
  rank block or radix tile (and histogram block), the route by length, the
  launches, threads, shared memory and scratch within their limits; ``rows_plan``: every unit of every buffer in
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


def write_order(order, r, n, nsplits, p, w):
    ng = n // nsplits
    i, j = p // nsplits, p % nsplits
    order[r * n + j * ng + i] = r * n + (w & np.uint64(0xFFFFFFFF)).astype(
        np.int64)


def look_back_replay(cnt, inclusive, rng):
    """The prefixes ``radix_pass_kernel``'s look-back finds for every tile
    after the first of every segment and digit (``cnt`` and ``inclusive``
    ``(T, tiles, bins)``: the tiles' counts and inclusive prefixes), all
    tiles at once: windows of ``RADIX_LOOKBACK`` statuses from the
    nearest, each status an aggregate or a prefix (tile 0 always a
    prefix), some not yet published at the first step, so the walk stops
    there and reads again.  Returns ``(T, tiles, bins)``, the first tile's
    row 0."""
    T, tiles, bins = cnt.shape
    prefix = rng.random((T, tiles, bins)) < 0.3
    prefix[:, 0] = True
    late = rng.random((T, tiles, bins)) < 0.2  # unpublished at first
    value = np.where(prefix, inclusive, cnt)
    r_ix, t_ix, d_ix = np.indices((T, tiles, bins))
    k = t_ix.copy()  # the statuses below k are still to be summed
    total = np.zeros((T, tiles, bins), np.int64)
    done = t_ix == 0
    first = True
    while not done.all():
        stop = done.copy()  # ended this step: a prefix or a late status
        step = np.zeros((T, tiles, bins), np.int64)
        for j in range(shk.RADIX_LOOKBACK):
            at = k - 1 - j
            i = np.maximum(at, 0)
            live = (at >= 0) & ~stop
            unpublished = live & late[r_ix, i, d_ix] & first
            stop |= unpublished
            add = live & ~unpublished
            total += np.where(add, value[r_ix, i, d_ix], 0)
            step += add
            ended = add & prefix[r_ix, i, d_ix]
            done |= ended
            stop |= ended
        k = np.where(done, k, k - step)
        assert np.all(done | (k >= 1))  # tile 0's prefix ends every walk
        first = False
    return total


def radix_ranks(digits, items):
    """Each word's rank among its warp's words of its digit, as the warps
    of ``radix_pass_kernel`` count them: ``digits`` ``(..., items * 32)``
    a warp (``RADIX_BINS`` for a padding lane), 32 at a time in order,
    the lanes below with the same digit (``__match_any_sync``) beside a
    running count a digit; returns the ranks and the warps' counts."""
    lead = digits.shape[:-1]
    count = np.zeros(lead + (shk.RADIX_BINS + 1,), np.int64)
    rank = np.empty(digits.shape, np.int64)
    below = np.tril(np.ones((32, 32), bool), -1)  # [lane, lower lane]
    for i in range(items):
        d = digits[..., i * 32:(i + 1) * 32]
        peers = d[..., :, None] == d[..., None, :]
        lower = (peers & below).sum(-1)
        c = np.take_along_axis(count, d, axis=-1)
        rank[..., i * 32:(i + 1) * 32] = c + lower
        leader = lower == 0
        np.put_along_axis(count, np.where(leader, d, shk.RADIX_BINS),
                          np.where(leader, c + peers.sum(-1), 0), axis=-1)
    return rank, count[..., :shk.RADIX_BINS]


def emulate_radix(keys, plan, rng):
    """The radix route as ``emcee_group_order`` launches it: the histogram
    blocks' counts, then each pass's tiles ranking their words by digit,
    their prefixes by the look-back and the scatter of each tile in digit
    order.  Returns each segment's sorted words."""
    T, n = keys.shape
    tile, tiles = plan.chunk, plan.chunks
    warps = plan.threads // 32
    items = tile // plan.threads
    bins = shk.RADIX_BINS
    k32 = keys.astype(np.uint64) & np.uint64(0xFFFFFFFF)
    per = -(-n // plan.hist)
    part = np.zeros((T, plan.hist, shk.RADIX_PASSES, bins), np.int64)
    for b in range(plan.hist):
        blk = k32[:, b * per:min(n, (b + 1) * per)]
        for p in range(shk.RADIX_PASSES):
            d = ((blk >> np.uint64(8 * p)) & np.uint64(bins - 1)).astype(
                np.int64)
            for r in range(T):
                part[r, b, p] = np.bincount(d[r], minlength=bins)
    words = (k32 << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    live = np.arange(tiles * tile) < n
    r_ix, t_ix, w_ix = (x[..., None] for x in np.indices((T, tiles, warps)))
    for p in range(shk.RADIX_PASSES):
        shift = np.uint64(32 + 8 * p)
        w = np.zeros((T, tiles * tile), np.uint64)
        w[:, :n] = words
        d = ((w >> shift) & np.uint64(bins - 1)).astype(np.int64)
        d[:, ~live] = bins
        d = d.reshape(T, tiles, warps, items * 32)
        rank, count = radix_ranks(d, items)
        warp_off = np.cumsum(count, axis=2) - count
        cnt = count.sum(axis=2)  # (T, tiles, bins)
        local = np.cumsum(cnt, axis=-1) - cnt
        total = part[:, :, p].sum(axis=1)
        bucket = np.cumsum(total, axis=-1) - total  # tile 0's starts
        inclusive = bucket[:, None] + np.cumsum(cnt, axis=1)
        before = look_back_replay(cnt, inclusive, rng)
        before[:, 0] = bucket
        # Each tile's words in digit order in shared memory, then out.
        ok = d < bins
        dc = np.minimum(d, bins - 1)
        slot = local[r_ix, t_ix, dc] + warp_off[r_ix, t_ix, w_ix, dc] + rank
        smem = np.zeros((T, tiles, tile), np.uint64)
        rr = np.broadcast_to(r_ix, d.shape)[ok]
        tt = np.broadcast_to(t_ix, d.shape)[ok]
        assert not np.any(np.bincount(
            (rr * tiles + tt) * tile + slot[ok]) > 1)
        smem[rr, tt, slot[ok]] = w.reshape(d.shape)[ok]
        sd = ((smem >> shift) & np.uint64(bins - 1)).astype(np.int64)
        q = np.take_along_axis(before - local, sd, axis=-1) + np.arange(tile)
        out = np.full((T, n), PAD)
        at = live.reshape(tiles, tile)
        for r in range(T):
            out[r, q[r][at]] = smem[r][at]
        words = out
    return words


def emulate_group_order(keys, nsplits, plan, rng=None):
    """K16 as ``emcee_group_order`` launches it with ``plan``."""
    T, n = keys.shape
    order = np.full(T * n, -1, np.int64)
    words = ((keys.astype(np.uint64) << np.uint64(32))
             | np.arange(n, dtype=np.uint64))
    if plan.route == "radix":
        sw = emulate_radix(keys, plan, rng or np.random.default_rng(0))
        for r in range(T):
            write_order(order, r, n, nsplits, np.arange(n), sw[r])
        return order
    for r in range(T):
        for b in range(plan.chunks):  # a thread a word: its rank
            e = np.arange(b * plan.threads, min((b + 1) * plan.threads, n))
            p = (words[r][None, :] < words[r][e, None]).sum(axis=1)
            write_order(order, r, n, nsplits, p, words[r][e])
    return order


@pytest.mark.parametrize("kind", ["equal", "two values", "sorted",
                                  "reversed", "random"])
@pytest.mark.parametrize("T,n,nsplits,force", [
    (16, 256, 2, None), (3, 15, 3, None), (2, 2, 2, None), (1, 1, 1, None),
    (2, 2048, 4, None), (1, 3000, 2, None), (2, 300, 3, ("tile", 256)),
    (2, 37, 1, ("tile", 256)), (1, 100, 4, ("tile", 256)),
    (3, 96, 2, ("tile", 256)), (1, 5003, 1, None), (2, 9000, 3, None),
    (1, 20_000, 2, None), (2, 1000, 2, ("tile", 256)),
    (3, 4098, 1, None), (2, 5000, 2, ("tile", 256)),
    (1, 20_000, 2, ("tile", 256)), (4, 6000, 3, ("tile", 4096))])
def test_k16_algorithm_equals_the_plain_order(kind, T, n, nsplits, force):
    """Every route by the plan, and the radix route forced on short
    segments; the last four shapes: a segment just above the rank route's
    limit, ``T > 1`` long segments, tens of tiles and ties across
    tiles."""
    keys = tied_keys(kind, T, n, np.random.default_rng(3 * n + T))
    plan = shk.shuffle_plan(T, n, nsplits, 132, tile=force and force[1])
    want = shk.group_order_plain(torch.from_numpy(keys), nsplits).numpy()
    got = emulate_group_order(keys, nsplits, plan,
                              np.random.default_rng(n + 7 * T))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T,n,tile", [(1, 20_000, None), (3, 5000, 256)])
def test_k16_radix_sorted_words_and_order_equal_the_plain_version(T, n,
                                                                  tile):
    """``sorted_words`` with ``order`` (one split): the radix route's last
    pass writes the sorted words and the flat rows."""
    keys = tied_keys("random", T, n, np.random.default_rng(n))
    keys[:, ::7] = 5  # ties across tiles
    plan = shk.shuffle_plan(T, n, 1, 132, tile=tile)
    assert plan.route == "radix"
    words = torch.empty(T, n, dtype=torch.int64)
    order = torch.empty(T * n, dtype=torch.int64)
    shk.sorted_words(torch.from_numpy(keys), words, order)
    sw = emulate_radix(keys, plan, np.random.default_rng(1))
    np.testing.assert_array_equal(sw.view(np.int64), words.numpy())
    np.testing.assert_array_equal(
        emulate_group_order(keys, 1, plan, np.random.default_rng(2)),
        order.numpy())


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
    with pytest.raises(ValueError, match="tile must be one of"):
        shk.shuffle_plan(1, 100, 2, 132, tile=512)
    with pytest.raises(ValueError, match="bad segments"):
        shk.shuffle_plan(1, 9, 2, 132)


@settings(max_examples=200, deadline=None)
@given(T=st.integers(1, 64), n_per=st.integers(1, 60_000),
       ns=st.integers(1, 4), n_sm=st.sampled_from([1, 78, 132, 144]),
       tile=st.sampled_from([None, 256, 1024, 4096]))
def test_shuffle_plan_covers_every_walker_once(T, n_per, ns, n_sm, tile):
    n = n_per * ns
    plan = shk.shuffle_plan(T, n, ns, n_sm, tile=tile)
    if tile is None and n <= shk.RANK_MAX:
        assert plan == (
            "rank", 0, shk.RANK_THREADS, -(-n // shk.RANK_THREADS), 0,
            8 * shk.RANK_MAX)
        assert (plan.chunks - 1) * plan.threads < n <= (
            plan.chunks * plan.threads)
        assert plan.launches == 1 and plan.smem <= shk.SMEM_LIMIT
        return
    # The radix route: tiles of 256 threads x 1, 4 or 16 keys cover every
    # key of a segment once; the histogram blocks too.
    chunk = plan.chunk
    assert plan.route == "radix" and chunk == (tile or chunk)
    assert chunk in shk.RADIX_TILES and plan.threads == shk.RADIX_THREADS
    assert chunk // plan.threads in (1, 4, 16)
    assert (plan.chunks - 1) * chunk < n <= plan.chunks * chunk
    if tile is None:  # the largest tile whose tiles fill half the card
        fill = [t for t in shk.RADIX_TILES if 2 * T * -(-n // t) >= n_sm]
        assert chunk == (fill[0] if fill else 256)
    per = -(-n // plan.hist)
    assert 1 <= plan.hist <= n and (plan.hist - 1) * per < n <= (
        plan.hist * per)
    assert T * plan.hist <= max(T, n_sm + T)
    assert plan.launches == 1 + shk.RADIX_PASSES == 5
    assert plan.smem == shk.radix_smem(chunk) <= shk.SMEM_LIMIT
    # The scratch: two buffers of words, then the 32-bit status words and
    # digit counts.
    u32 = 2 * T * plan.chunks * 256 + T * plan.hist * 4 * 256
    assert shk.radix_scratch(plan, T, n) * 2 >= 4 * T * n + u32


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
