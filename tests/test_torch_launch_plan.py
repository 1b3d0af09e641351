"""The launch plans of K1 and K2 (``emcee_tpu_torch/ops/_wrap.py``
``tile_plan``) and of K5a and K5b (``de_plan``), checked on the host: the
tiles cover the split once, the grid fills the card, shared memory stays
under 48 KB, and the float4 and bulk-copy paths are taken only on 16-byte
aligned spans.  The kernels read the plan as it is
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
    BLOCKS_PER_SM, DE_THREADS, K5_BLOCKS_PER_SM, SMEM_LIMIT,
    SNOOKER_TILE_MAX, STATIC_SMEM, TILE_MAX, TILE_MIN, de_plan, tile_plan)

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
