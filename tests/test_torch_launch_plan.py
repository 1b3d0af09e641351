"""The launch plans of K1 and K2 (``emcee_tpu_torch/ops/_wrap.py``
``tile_plan``, K2's rung kernel, ``rung_plan``, and K2's blob leaves,
``accept_kernel.leaf_plan``), of K5a
and K5b (``de_plan``, with and without the rung axis) and of K11 (``langevin_kernel.langevin_plan``),
checked on the host: the tiles cover the split once, the grid fills the
card (K11's in one wave), shared memory stays under 48 KB, the float4 and
bulk-copy paths are taken only on 16-byte aligned spans, scalar blob
leaves go through registers, and the kernels' division-free index walks
visit every unit once.  The kernels read the plan as it is
(``csrc/stretch_propose.cu``, ``csrc/accept_select.cu``,
``csrc/de_propose.cu``, ``csrc/snooker_propose.cu``); ``chip_smoke.py``
holds them against their plain versions on the card."""

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from emcee_tpu_torch.ops import _wrap
from emcee_tpu_torch.ops._wrap import (
    BLOCKS_PER_SM, DE_THREADS, K5_BLOCKS_PER_SM, RUNG_ROW_REGS,
    RUNG_THREADS, RUNG_THREADS_LIMIT, SMEM_LIMIT, SNOOKER_TILE_MAX,
    STATIC_SMEM, TILE_MAX, TILE_MIN, de_plan, rung_plan, tile_plan)
from emcee_tpu_torch.ops.accept_kernel import (
    BLOB_CAPACITY, ROW_LEAVES, RUNG_LEAF_UNITS, RUNG_REG_LEAVES, UPR_SHIFT,
    blob_unit, inv_upr, leaf_plan)
from emcee_tpu_torch.ops.langevin_kernel import (
    LANGEVIN_BLOCKS_PER_SM, LANGEVIN_THREADS, langevin_plan)

H100_SMS = 132


def spans(plan, ng, nd, split, coords_ptr, q_ptr):
    """Each block's walkers ``[t0, t0 + cnt)`` as the kernels compute
    them, and the byte addresses where its rows start in coords and q."""
    t0 = np.arange(plan.grid, dtype=np.int64) * plan.tile
    cnt = np.minimum(plan.tile, ng - t0)
    own = coords_ptr + 4 * (split * ng + t0) * nd
    q = q_ptr + 4 * t0 * nd
    return t0, cnt, own, q


shapes = st.tuples(
    st.integers(2, 4),  # nsplits
    st.integers(1, 100_000),  # ng
    st.integers(1, 4000),  # ndim
    st.integers(1, 200),  # SMs
    st.integers(0, 3),  # coords base: 4 bytes x this past 16-byte alignment
    st.integers(0, 3),  # q base, likewise
    st.booleans(),  # stage (K2) or not (K1)
).flatmap(lambda s: st.tuples(st.just(s), st.integers(0, s[0] - 1)))


def draw(case):
    (nsplits, ng, nd, n_sm, c_off, q_off, stage), split = case
    coords_ptr = (1 << 20) + 4 * c_off
    q_ptr = (3 << 20) + 4 * q_off
    plan = tile_plan(ng, nd, split, n_sm, coords_ptr, q_ptr, stage=stage)
    return plan, ng, nd, split, n_sm, coords_ptr, q_ptr, stage


# Both paths' shapes on the H100, K1 (no staging) and K2 (staged): the
# main path (ng 50000, ndim 5) and workload 3 (ng 5000, ndim 100).
PATHS = [((2, 50_000, 5, H100_SMS, 0, 0, stage), split)
         for stage in (False, True) for split in (0, 1)]
PATHS += [((2, 5_000, 100, H100_SMS, 0, 0, stage), split)
          for stage in (False, True) for split in (0, 1)]


def with_paths(test):
    for case in PATHS:
        test = example(case)(test)
    return settings(max_examples=200, deadline=None)(given(shapes)(test))


@with_paths
def test_tiles_cover_the_split_exactly_once(case):
    plan, ng, nd, split, *_ = draw(case)
    assert plan.tile & (plan.tile - 1) == 0
    assert TILE_MIN <= plan.tile <= TILE_MAX
    t0, cnt, _, _ = spans(plan, ng, nd, split, 0, 0)
    assert t0[0] == 0 and (t0 + cnt)[-1] == ng
    assert (cnt > 0).all() and (cnt <= plan.tile).all()
    assert (t0[1:] == (t0 + cnt)[:-1]).all()


@with_paths
def test_the_grid_fills_the_card_where_the_split_allows(case):
    plan, ng, nd, split, n_sm, *_ = draw(case)
    most = -(-ng // TILE_MIN)  # blocks at the smallest tile
    assert plan.grid >= min(BLOCKS_PER_SM * n_sm, most)
    if most >= n_sm:
        assert plan.grid >= n_sm
    # The largest tile that does so: twice the tile would fall short, or
    # its q span would not fit in shared memory when staged.
    if plan.tile < TILE_MAX:
        short = -(-ng // (2 * plan.tile)) < BLOCKS_PER_SM * n_sm
        too_wide = plan.stage and (
            8 * plan.tile * nd > SMEM_LIMIT - STATIC_SMEM)
        assert short or too_wide


@with_paths
def test_shared_memory_stays_under_48_kb(case):
    plan, ng, nd, _, _, _, _, stage = draw(case)
    assert plan.smem + STATIC_SMEM <= SMEM_LIMIT == 48 * 1024
    assert plan.smem == (4 * plan.tile * nd if plan.stage else 0)
    assert plan.stage <= stage
    if stage and not plan.stage:
        assert (4 * TILE_MIN * nd > SMEM_LIMIT - STATIC_SMEM
                or draw(case)[6] % 16)


@with_paths
def test_vector_path_only_where_both_spans_are_aligned(case):
    plan, ng, nd, split, _, coords_ptr, q_ptr, _ = draw(case)
    _, _, own, q = spans(plan, ng, nd, split, coords_ptr, q_ptr)
    aligned = bool((own % 16 == 0).all() and (q % 16 == 0).all())
    if plan.vec:
        assert aligned
    elif coords_ptr % 16 == 0 and q_ptr % 16 == 0:
        assert not aligned  # taken wherever aligned bases allow it
    if plan.stage:  # a bulk copy's source: every tile's q span
        assert (q % 16 == 0).all()


@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("nw, nd, tile, stage_smem", [
    (100_000, 5, 128, 2560),  # the main path: 391 blocks
    (10_000, 100, 16, 6400),  # workload 3: 313 blocks
])
def test_plan_at_the_paths_shapes(nw, nd, tile, stage_smem, split):
    ng = nw // 2
    k1 = tile_plan(ng, nd, split, H100_SMS, 1 << 20, 1 << 21)
    k2 = tile_plan(ng, nd, split, H100_SMS, 1 << 20, 1 << 21, stage=True)
    assert k1 == (tile, -(-ng // tile), 1, 0, 0)
    assert k2 == (tile, -(-ng // tile), 1, 1, stage_smem)
    assert k1.grid >= BLOCKS_PER_SM * H100_SMS


# -- K5a and K5b ---------------------------------------------------------

K5 = ["de", "snooker"]


def draw_k5(case, kind):
    """``case`` read for K5a (``stage`` asks for the bulk copy) or K5b
    (``stage`` ignored: K5b has no staged variant)."""
    (nsplits, ng, nd, n_sm, c_off, q_off, stage), split = case
    coords_ptr = (1 << 20) + 4 * c_off
    q_ptr = (3 << 20) + 4 * q_off
    plan = de_plan(ng, nd, split, n_sm, coords_ptr, q_ptr,
                   snooker=kind == "snooker", stage=stage)
    return plan, ng, nd, split, n_sm, coords_ptr, q_ptr, stage


def with_k5(test):
    return pytest.mark.parametrize("kind", K5)(with_paths(test))


@with_k5
def test_k5_tiles_cover_the_split_exactly_once(kind, case):
    plan, ng, nd, split, *_ = draw_k5(case, kind)
    cap = SNOOKER_TILE_MAX if kind == "snooker" else TILE_MAX
    assert plan.tile & (plan.tile - 1) == 0
    assert TILE_MIN <= plan.tile <= cap
    assert plan.grid == -(-ng // plan.tile)
    t0, cnt, _, _ = spans(plan, ng, nd, split, 0, 0)
    assert t0[0] == 0 and (t0 + cnt)[-1] == ng
    assert (cnt > 0).all() and (cnt <= plan.tile).all()
    assert (t0[1:] == (t0 + cnt)[:-1]).all()


@with_k5
def test_k5_grid_fills_the_card_and_threads_fit_the_tile(kind, case):
    plan, ng, nd, split, n_sm, *_ = draw_k5(case, kind)
    most = -(-ng // TILE_MIN)
    assert plan.grid >= min(K5_BLOCKS_PER_SM * n_sm, most)
    if most >= n_sm:
        assert plan.grid >= n_sm
    cap = SNOOKER_TILE_MAX if kind == "snooker" else TILE_MAX
    if plan.tile < cap:
        short = -(-ng // (2 * plan.tile)) < K5_BLOCKS_PER_SM * n_sm
        too_wide = plan.stage and (
            8 * plan.tile * nd > SMEM_LIMIT - STATIC_SMEM)
        assert short or too_wide
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    if kind == "snooker":  # one warp per walker
        assert plan.threads == 32 * plan.tile
    else:  # a walker thread each, and a last warp that holds none
        assert plan.threads >= 32 * -(-plan.tile // 32) + 32
        assert plan.threads in (DE_THREADS, TILE_MAX + 32)


@with_k5
def test_k5_shared_memory_stays_under_48_kb(kind, case):
    plan, ng, nd, split, _, coords_ptr, _, stage = draw_k5(case, kind)
    assert plan.smem + STATIC_SMEM <= SMEM_LIMIT == 48 * 1024
    assert plan.smem == (4 * plan.tile * nd if plan.stage else 0)
    assert plan.stage <= (stage and kind == "de")
    if plan.stage:  # a bulk copy's source: every tile's own rows
        _, _, own, _ = spans(plan, ng, nd, split, coords_ptr, 0)
        assert (own % 16 == 0).all()


@with_k5
def test_k5_vector_path_only_where_every_row_is_aligned(kind, case):
    plan, ng, nd, _, _, coords_ptr, q_ptr, _ = draw_k5(case, kind)
    nw = ng * case[0][0]
    # Partner and role rows start at any row of the ensemble, q rows at
    # any row of q: every row of both must start 16-byte aligned (row
    # addresses repeat modulo 16 bytes every 4 rows).
    rows = np.arange(min(nw, 8), dtype=np.int64)
    aligned = bool(((coords_ptr + 4 * rows * nd) % 16 == 0).all()
                   and ((q_ptr + 4 * rows[:ng] * nd) % 16 == 0).all())
    assert plan.vec == int(aligned)
    assert not plan.vec or nd % 4 == 0


@pytest.mark.parametrize("split", [0, 1])
def test_k5_plan_at_workload_3s_shape(split):
    ng, nd = 5_000, 100
    k5a = de_plan(ng, nd, split, H100_SMS, 1 << 20, 1 << 21)
    k5a_staged = de_plan(ng, nd, split, H100_SMS, 1 << 20, 1 << 21,
                         stage=True)
    k5b = de_plan(ng, nd, split, H100_SMS, 1 << 20, 1 << 21, snooker=True)
    assert k5a == (8, 625, DE_THREADS, 1, 0, 0)
    assert k5a_staged == (8, 625, DE_THREADS, 1, 1, 3200)
    assert k5b == (8, 625, 256, 1, 0, 0)
    assert k5a.grid >= K5_BLOCKS_PER_SM * H100_SMS
    # A misaligned q base or an odd ndim takes the scalar path.
    assert de_plan(ng, nd, split, H100_SMS, 1 << 20, (1 << 21) + 4).vec == 0
    assert de_plan(ng, 101, split, H100_SMS, 1 << 20, 1 << 21,
                   snooker=True).vec == 0


@pytest.mark.parametrize("kind", K5)
@settings(max_examples=150, deadline=None)
@given(st.integers(1, 64), st.integers(1, 2000), st.integers(1, 130),
       st.integers(2, 4), st.booleans(), st.integers(0, 3),
       st.integers(0, 3))
@example(16, 128, 5, 2, True, 0, 0)  # workload 4's DE split
@example(16, 64, 5, 4, True, 0, 0)  # workload 4's snooker split
@example(3, 3, 5, 3, True, 0, 0)  # rungs of 45 floats: staging dropped
def test_k5_rung_axis_plan(kind, rungs, ng, nd, nsplits, stage, c_off,
                           q_off):
    """K5a's and K5b's plan on the rung axis (``de_plan(..., rungs=,
    nsplits=)``): every rung's blocks count toward filling the card; the
    staged variant is kept only where every tile of every rung has its own
    rows 16-byte aligned (rungs of ``nsplits * ng`` rows in coords), and
    the float4 path only where every row of every rung is; one rung is the
    single-ensemble plan."""
    snooker = kind == "snooker"
    split = (ng + nd) % nsplits
    coords_ptr = (1 << 20) + 4 * c_off
    q_ptr = (3 << 20) + 4 * q_off
    plan = de_plan(ng, nd, split, H100_SMS, coords_ptr, q_ptr,
                   snooker=snooker, stage=stage, rungs=rungs,
                   nsplits=nsplits)
    single = de_plan(ng, nd, split, H100_SMS, coords_ptr, q_ptr,
                     snooker=snooker, stage=stage)
    if rungs == 1:
        assert plan == single
    assert plan.grid == -(-ng // plan.tile)
    assert plan.tile >= single.tile  # more rungs, fewer blocks a rung
    cap = SNOOKER_TILE_MAX if snooker else TILE_MAX
    if plan.tile < cap and not plan.stage:  # the tile twice as large
        assert rungs * -(-ng // (2 * plan.tile)) < (
            K5_BLOCKS_PER_SM * H100_SMS)
    if plan.tile > TILE_MIN:
        assert rungs * plan.grid >= K5_BLOCKS_PER_SM * H100_SMS
    assert plan.threads == (32 * plan.tile if snooker else max(
        DE_THREADS, 32 * -(-plan.tile // 32) + 32))
    nw = nsplits * ng
    t0 = np.arange(plan.grid, dtype=np.int64) * plan.tile
    for r in range(rungs):
        own = coords_ptr + 4 * ((r * nw + split * ng + t0) * nd)
        rows = coords_ptr + 4 * ((r * nw + np.arange(min(nw, 8))) * nd)
        q_rows = q_ptr + 4 * ((r * ng + np.arange(min(ng, 8))) * nd)
        if plan.stage:
            assert np.all(own % 16 == 0)
        if plan.vec:
            assert np.all(rows % 16 == 0) and np.all(q_rows % 16 == 0)
    misaligned = rungs > 1 and nw * nd % 4 != 0
    if misaligned:  # a rung's own rows would start off a 16-byte boundary
        assert not plan.stage
    assert plan.stage == (single.stage and not misaligned)
    assert plan.vec == single.vec
    if plan.stage:
        assert plan.smem == 4 * plan.tile * nd <= SMEM_LIMIT - STATIC_SMEM


def test_k5_rung_axis_plan_at_workload_4():
    """16 rungs: DE's splits of 128 and the snooker's of 64 walkers at
    5-D; every rung's blocks count (the one-ensemble plan of one rung has
    the same tile at this size), K5a staged (every rung's span 16-byte
    aligned: 256 x 5 floats), neither on the float4 path (ndim 5)."""
    de = de_plan(128, 5, 1, H100_SMS, 1 << 20, 1 << 21, stage=True,
                 rungs=16, nsplits=2)
    assert de == (TILE_MIN, 32, DE_THREADS, 0, 1, 4 * TILE_MIN * 5)
    assert de.grid * 16 == 512
    sn = de_plan(64, 5, 3, H100_SMS, 1 << 20, 1 << 21, snooker=True,
                 rungs=16, nsplits=4)
    assert sn == (TILE_MIN, 16, 32 * TILE_MIN, 0, 0, 0)
    # 3 splits of 3 walkers at 5-D: rung spans of 45 floats, not staged.
    assert de_plan(3, 5, 0, H100_SMS, 1 << 20, 1 << 21, stage=True,
                   rungs=2, nsplits=3).stage == 0
    assert de_plan(3, 5, 0, H100_SMS, 1 << 20, 1 << 21, stage=True).stage


def test_sm_count_is_read_once_per_device(monkeypatch):
    calls = []

    class Props:
        multi_processor_count = 132

    def props(index):
        calls.append(index)
        return Props

    _wrap.sm_count.cache_clear()
    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    try:
        assert [_wrap.sm_count(0) for _ in range(3)] == [132] * 3
        assert _wrap.sm_count(1) == 132
    finally:
        _wrap.sm_count.cache_clear()
    assert calls == [0, 1]


# -- K2's blob leaves (accept_kernel.leaf_plan) --------------------------

def leaf_cases():
    """Up to 40 blob leaves ``(src, dst, row bytes)`` at bases up to 15
    bytes past 16-byte alignment (rows of 4 and 8 bytes drawn often:
    scalar blobs)."""
    leaf = st.tuples(st.integers(0, 15), st.integers(0, 15),
                     st.one_of(st.sampled_from([4, 8]), st.integers(1, 600)))
    return st.lists(leaf, max_size=40)


@settings(max_examples=300, deadline=None)
@given(leaf_cases())
@example([(0, 0, 4)] * 3)  # the main path's blobs
@example([(0, 0, 4)] * 5)  # one too many for registers
@example([(0, 0, 240)] * 2 + [(0, 0, 4)])
def test_leaf_plan_reads_scalar_leaves_into_registers(raw):
    leaves = [((5 << 20) + (i << 22) + s, (7 << 20) + (i << 22) + d, row)
              for i, (s, d, row) in enumerate(raw)]
    descs, row_unit = leaf_plan(leaves)
    assert [d[:3] for d in descs] == leaves
    # Registers: every row one 4- or 8-byte unit, at most ROW_LEAVES.
    units = {blob_unit(*leaf) for leaf in leaves}
    scalar = (0 < len(leaves) <= ROW_LEAVES and len(units) == 1
              and units <= {4, 8}
              and all(row in units for _, _, row in leaves))
    assert row_unit == (units.pop() if scalar else 0)
    for src, dst, row, unit, inv in descs:
        assert unit == blob_unit(src, dst, row)
        assert src % unit == dst % unit == row % unit == 0
        assert inv == -(-(1 << UPR_SHIFT) // (row // unit))


@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("nw, nd, tile, stage_smem", [
    (100_000, 5, 128, 2560),  # the main path
    (10_000, 100, 16, 6400),  # workload 3
])
def test_blob_free_plan_is_the_tile_plan(nw, nd, tile, stage_smem, split):
    ng = nw // 2
    plan = tile_plan(ng, nd, split, H100_SMS, 1 << 20, 1 << 21, stage=True)
    assert plan == (tile, -(-ng // tile), 1, 1, stage_smem)
    assert leaf_plan([]) == ([], 0)


def test_leaf_plan_at_the_main_path_with_three_blobs():
    """The blob main path's three 4-byte leaves: read into registers (row
    unit 4), 4-byte units, one unit a row; more leaves, or two units,
    go to phase C."""
    leaves = [((1 << 24) * k, (1 << 25) * k, 4) for k in (1, 2, 3)]
    descs, row_unit = leaf_plan(leaves)
    assert row_unit == 4
    assert [d[3:] for d in descs] == [(4, 1 << 24)] * 3
    assert leaf_plan(leaves + leaves[:1])[1] == 4  # four: the most
    more, row_unit = leaf_plan(leaves * 6)
    assert row_unit == 0 and len(more) == 18 > BLOB_CAPACITY
    # A float64 scalar and a float32 one share no unit: phase C.
    assert leaf_plan(leaves[:1] + [(1 << 26, 1 << 27, 8)])[1] == 0
    # An 8-byte row at a 4-byte aligned base is two 4-byte units.
    assert leaf_plan([(4, 0, 8)]) == ([(4, 0, 8, 4, 1 << 23)], 0)


@pytest.mark.parametrize("upr", [1, 2, 3, 7, 24, 255, 256, 257, 1000,
                                 65535, 65536, 1 << 20])
def test_inv_upr_divides_a_threads_first_unit_and_the_step(upr):
    inv = inv_upr(upr * 4, 4)
    k = np.arange(TILE_MAX + 1, dtype=np.uint64)
    assert np.array_equal((k * np.uint64(inv)) >> np.uint64(UPR_SHIFT),
                          k // np.uint64(upr))
    assert TILE_MAX * inv < 1 << 33 and (TILE_MAX - 1) * inv < 1 << 32


@pytest.mark.parametrize("upr, cnt", [(1, 128), (3, 128), (3, 11), (7, 16),
                                      (100, 5), (300, 4), (1000, 2)])
def test_phase_c_walk_visits_every_unit_once(upr, cnt):
    """csrc/accept_select.cu select_leaf's walk, thread by thread: unit k
    of the tile span is unit u of walker w's row, with no division."""
    inv = inv_upr(upr, 1)
    seen = []
    for t in range(TILE_MAX):
        w = (t * inv) >> UPR_SHIFT
        u = t - w * upr
        dw = (TILE_MAX * inv) >> UPR_SHIFT
        du = TILE_MAX - dw * upr
        k = t
        while w < cnt:
            assert k == w * upr + u and 0 <= u < upr
            seen.append(k)
            k, u, w = k + TILE_MAX, u + du, w + dw
            if u >= upr:
                u, w = u - upr, w + 1
    assert sorted(seen) == list(range(cnt * upr))


# -- K11 (langevin_kernel.langevin_plan) ---------------------------------


@settings(max_examples=300, deadline=None)
@given(st.integers(0, 3_000_000), st.integers(1, 200))
@example(100_000, H100_SMS)
@example(5_000, H100_SMS)
def test_langevin_plan_is_one_wave_that_covers_the_rows(n, n_sm):
    plan = langevin_plan(n, n_sm)
    if n == 0:
        assert plan == (1, 1)  # the jitter alone
        return
    assert plan.grid == -(-n // plan.tile) <= n_sm * LANGEVIN_BLOCKS_PER_SM
    assert (plan.grid - 1) * plan.tile < n <= plan.grid * plan.tile
    # Evenly spread: a tile one row shorter would need another wave.
    assert plan.tile == 1 or (
        -(-n // (plan.tile - 1)) > n_sm * LANGEVIN_BLOCKS_PER_SM)


@settings(max_examples=300, deadline=None)
@given(st.integers(0, 200_000), st.integers(1, 200), st.integers(1, 64))
@example(256, H100_SMS, 16)
@example(128, H100_SMS, 16)
def test_langevin_plan_spreads_every_rung_over_one_wave(n, n_sm, rungs):
    """K11's rung axis: ``grid`` blocks of ``tile`` rows cover each rung's
    rows once, every rung's blocks fill at most one wave (one ragged block
    a rung beyond it), a tile one row shorter would need more, and one
    rung is the one-ensemble plan."""
    plan = langevin_plan(n, n_sm, rungs)
    wave = n_sm * LANGEVIN_BLOCKS_PER_SM
    if rungs == 1:
        assert plan == langevin_plan(n, n_sm)
    if n == 0:
        assert plan == (1, 1)
        return
    assert (plan.grid - 1) * plan.tile < n <= plan.grid * plan.tile
    assert rungs * (plan.grid - 1) < wave
    assert plan.tile == 1 or rungs * -(-n // (plan.tile - 1)) > wave


@pytest.mark.parametrize("n, nd, plan", [
    (100_000, 5, (253, 396)),  # bench.py's MALA stage
    (5_000, 100, (13, 385)),  # EnsembleMALAMove's split on workload 3
])
def test_langevin_plan_at_the_paths_shapes(n, nd, plan):
    """The plan takes no base address: the kernel reads and writes 4-byte
    words, so a split half at any base gets the same plan."""
    assert langevin_plan(n, H100_SMS) == plan
    assert plan[1] <= H100_SMS * LANGEVIN_BLOCKS_PER_SM


@pytest.mark.parametrize("rows, nd", [(1, 1), (5, 1), (127, 5), (253, 5),
                                      (10, 100), (3, 128), (2, 513),
                                      (1, 1000)])
def test_k11_walk_visits_every_item_once(rows, nd):
    """csrc/langevin_step.cu's item walk, thread by thread: item i is
    pair k of row r of the tile, stepped with no division."""
    npairs = (nd + 1) // 2
    seen = []
    for t in range(LANGEVIN_THREADS):
        r, k = divmod(t, npairs)
        dr, dk = divmod(LANGEVIN_THREADS, npairs)
        for i in range(t, rows * npairs, LANGEVIN_THREADS):
            assert i == r * npairs + k and 0 <= k < npairs
            seen.append((r, k))
            k, r = k + dk, r + dr
            if k >= npairs:
                k, r = k - npairs, r + 1
    assert sorted(seen) == [(r, k) for r in range(rows)
                            for k in range(npairs)]


@settings(max_examples=150, deadline=None)
@given(st.integers(1, 64), st.integers(1, 2000), st.integers(1, 130),
       st.integers(2, 4), st.booleans(), st.integers(0, 3),
       st.integers(0, 3))
@example(16, 128, 5, 2, False, 0, 0)  # workload 4's K1
@example(16, 128, 5, 2, True, 0, 0)  # and K2
def test_rung_axis_plan(rungs, ng, nd, nsplits, stage, c_off, q_off):
    """The rung axis (``tile_plan(..., rungs=, nsplits=)``): every rung's
    blocks count toward filling the card, and the float4 and bulk-copy
    paths are taken only where every tile of every rung is 16-byte
    aligned in coords (rungs of nsplits * ng rows) and in q (rungs of ng
    rows); one rung is the single-ensemble plan."""
    split = (ng + nd) % nsplits
    coords_ptr = (1 << 20) + 4 * c_off
    q_ptr = (3 << 20) + 4 * q_off
    plan = tile_plan(ng, nd, split, H100_SMS, coords_ptr, q_ptr,
                     stage=stage, rungs=rungs, nsplits=nsplits)
    if rungs == 1:
        assert plan == tile_plan(ng, nd, split, H100_SMS, coords_ptr, q_ptr,
                                 stage=stage)
    assert plan.grid == -(-ng // plan.tile)
    if plan.tile > TILE_MIN:
        assert rungs * plan.grid >= BLOCKS_PER_SM * H100_SMS
    nw = nsplits * ng
    for r in range(rungs):
        t0 = np.arange(plan.grid, dtype=np.int64) * plan.tile
        own = coords_ptr + 4 * ((r * nw + split * ng + t0) * nd)
        q = q_ptr + 4 * ((r * ng + t0) * nd)
        if plan.vec:
            assert np.all(own % 16 == 0) and np.all(q % 16 == 0)
        if plan.stage:
            assert np.all(q % 16 == 0)
    if plan.stage:
        assert plan.smem == 4 * plan.tile * nd <= SMEM_LIMIT - STATIC_SMEM


# -- K2's rung kernel (_wrap.rung_plan, leaf_plan(..., rungs=True)) ------

@settings(max_examples=200, deadline=None)
@given(st.integers(1, 5000), st.integers(1, 300), st.integers(1, 64),
       st.integers(2, 4))
@example(128, 5, 16, 2)  # workload 4's K2
@example(33, 9, 3, 3)  # a tail of one walker, a row past registers
def test_rung_kernel_plan_covers_every_rungs_walkers_once(ng, nd, rungs,
                                                          nsplits):
    """``rung_plan``: one thread a walker in blocks of ``RUNG_THREADS``, a
    warp multiple, the grid's second dimension the rung; block ``(b, r)``'s
    thread ``x`` takes walker ``b * threads + x`` of rung ``r``'s split
    when it is below ``ng``, so every walker of every rung's split is
    taken once; the q row goes through registers exactly when it has at
    most ``RUNG_ROW_REGS`` floats."""
    plan = rung_plan(ng, nd)
    assert plan.threads == RUNG_THREADS and RUNG_THREADS % 32 == 0
    assert RUNG_THREADS <= RUNG_THREADS_LIMIT
    assert plan.grid == -(-ng // plan.threads)
    i = (np.arange(plan.grid)[:, None] * plan.threads
         + np.arange(plan.threads)[None, :]).ravel()
    i = i[i < ng]
    split = (ng + nd) % nsplits
    nw = nsplits * ng
    rows = (np.arange(rungs)[:, None] * nw + split * ng + i[None, :]).ravel()
    want = (np.arange(rungs)[:, None] * nw + split * ng
            + np.arange(ng)[None, :]).ravel()
    assert np.array_equal(np.sort(rows), want)
    assert plan.reg_row == int(nd <= RUNG_ROW_REGS)


def test_rung_kernel_plan_at_workload_4():
    """16 rungs x 128 walkers a split: a block of 128 a rung, 16 in all,
    the 5-D rows in registers (the tiled plan ran 512 blocks of 256
    threads, 4 walkers each)."""
    assert rung_plan(128, 5) == (128, 1, 1)
    assert tile_plan(128, 5, 0, H100_SMS, 0, 0, stage=True, rungs=16,
                     nsplits=2).grid * 16 == 512


def rung_leaf_cases():
    """Up to 24 blob leaves ``(src, dst, row bytes)`` at bases up to 15
    bytes past 16-byte alignment, short rows of 4-byte units drawn
    often."""
    leaf = st.tuples(st.integers(0, 15), st.integers(0, 15),
                     st.one_of(st.sampled_from([4, 8, 12, 20, 32, 36]),
                               st.integers(1, 80)))
    return st.lists(leaf, max_size=24)


@settings(max_examples=300, deadline=None)
@given(rung_leaf_cases())
@example([(0, 0, 4)] * 4)  # logL, logP and two user scalars
@example([(0, 0, 4)] * 3 + [(0, 0, 20)])  # phase 15's (logL, logP, 2 logL, x)
@example([(0, 0, 4)] * 5)  # one too many for registers
@example([(0, 0, 36), (0, 0, 3), (2, 2, 8), (0, 0, 8)])
def test_leaf_plan_on_the_rung_axis_widened_register_path(raw):
    """On the rung axis the first ``RUNG_REG_LEAVES`` leaves whose rows are
    1 to ``RUNG_LEAF_UNITS`` 4-byte units (bases and row divisible by 4)
    go first, in their order, through registers; every other leaf follows
    in its own order, copied after the decision."""
    leaves = [((5 << 20) + (i << 22) + s, (7 << 20) + (i << 22) + d, row)
              for i, (s, d, row) in enumerate(raw)]
    descs, n_reg = leaf_plan(leaves, rungs=True)
    fits = [i for i, (s, d, row) in enumerate(leaves)
            if s % 4 == d % 4 == row % 4 == 0
            and row <= 4 * RUNG_LEAF_UNITS]
    reg = fits[:RUNG_REG_LEAVES]
    assert n_reg == len(reg)
    order = reg + [i for i in range(len(leaves)) if i not in reg]
    assert [d[:3] for d in descs] == [leaves[i] for i in order]
    for src, dst, row, unit, inv in descs:
        assert unit == blob_unit(src, dst, row)
        assert inv == inv_upr(row, unit)
    for _, _, row, unit, _ in descs[:n_reg]:
        assert unit >= 4 and 1 <= row // 4 <= RUNG_LEAF_UNITS


def test_leaf_plan_on_the_rung_axis_at_phase_15s_blobs():
    """The tempered logL and logP and the blobs ``(2 logL, x)`` of 5
    floats all ride registers; an 8-byte scalar is two 4-byte units and
    rides them too; a row of 9 floats, int8 rows of 3 and a 4-byte row at
    a base 2 bytes past a boundary are copied after the decision; past
    16 leaves the rest take blob-only launches (``BLOB_CAPACITY``)."""
    base = [((1 << 24) * k, (1 << 25) * k, 4) for k in (1, 2, 3)]
    x = (1 << 26, 1 << 27, 20)
    descs, n_reg = leaf_plan(base + [x], rungs=True)
    assert n_reg == 4 and [d[:3] for d in descs] == base + [x]
    assert leaf_plan([(8, 16, 8)], rungs=True)[1] == 1
    nine, odd, half = (0, 0, 36), (0, 0, 3), (2, 2, 4)
    descs, n_reg = leaf_plan([nine, base[0], odd, half, base[1]],
                             rungs=True)
    assert n_reg == 2
    assert [d[:3] for d in descs] == [base[0], base[1], nine, odd, half]
    many, n_reg = leaf_plan(base * 6, rungs=True)
    assert n_reg == RUNG_REG_LEAVES and len(many) == 18 > BLOB_CAPACITY
    # One ensemble keeps its rule: four scalars of one unit, or phase C.
    assert leaf_plan(base + [x])[1] == 0
