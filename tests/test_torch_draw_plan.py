"""The launch plan of K14, the counter-based Philox draws
(``emcee_tpu_torch/ops/philox_kernel.py`` ``draw_plan``, and
``ops/_wrap.py`` ``divisor``), checked on the host: the kernel's threads
(one a counter over every rung's counters, in blocks of ``threads``)
visit every counter of every rung exactly once, a thread's rung, row and
column by a multiply-high and a shift are the division's, blocks are
``DRAW_THREADS``, a warp multiple, and the one-vector stores are taken
only where every row is whole counters.  ``csrc/philox_draw.cu``
reads the plan as it is; ``chip_smoke.py`` phase 16 holds the kernel
against its plain version on the card over forced plans too."""

import numpy as np
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st

from emcee_tpu_torch.ops import _build
from emcee_tpu_torch.ops._wrap import divisor
from emcee_tpu_torch.ops.philox_kernel import (
    DRAW_THREADS, DRAW_THREADS_LIMIT, draw_plan)

def kernel_quotient(t, k, mul, shr):
    """``t // k`` as the kernel computes it: ``t`` itself for ``k == 1``,
    else ``__umulhi(t, mul) >> shr`` in 32-bit words."""
    t = np.asarray(t, dtype=np.uint64)
    if k == 1:
        return t
    return ((t * np.uint64(mul)) >> np.uint64(32)) >> np.uint64(shr)


@settings(max_examples=300, deadline=None)
@given(st.integers(1, 2**31 - 1), st.lists(st.integers(0, 2**31 - 1),
                                           max_size=50))
@example(3, [2**31 - 1, 2**31 - 2, 2**31 - 3])
@example(2**30 + 1, [2**31 - 1, 2**30, 2**30 + 1])
@example(2**31 - 1, [2**31 - 1, 2**31 - 2])
def test_divisor_divides_every_counter_index(k, ts):
    """``divisor`` gives the exact quotient for every index below
    ``2**31``; ``mul`` fits a 32-bit word."""
    mul, shr = divisor(k)
    assert 0 <= mul < 2**32 and 0 <= shr <= 31
    edges = [0, 1, k - 1, k, k + 1, 2 * k - 1, 2**31 - 1,
             (2**31 - 1) // k * k, (2**31 - 1) // k * k - 1]
    t = np.array([x for x in edges + ts if 0 <= x < 2**31], dtype=np.int64)
    assert np.array_equal(kernel_quotient(t, k, mul, shr).astype(np.int64),
                          t // k)


@pytest.mark.parametrize("k", list(range(1, 70)) + [255, 256, 257, 4096])
def test_divisor_over_a_range_of_indices(k):
    mul, shr = divisor(k)
    t = np.arange(0, 1 << 16, dtype=np.int64)
    assert np.array_equal(kernel_quotient(t, k, mul, shr).astype(np.int64),
                          t // k)


def test_divisor_refuses_counts_out_of_range():
    for k in (0, -1, 2**31):
        with pytest.raises(ValueError):
            divisor(k)


def walk(plan, rows, k, ntemps):
    """Every ``(block, thread) -> (rung, r, j)`` the kernel visits, as
    arrays of the thread's index, its rung and its counter's row and
    column."""
    b = np.arange(plan.blocks, dtype=np.int64)[:, None]
    x = np.arange(plan.threads, dtype=np.int64)[None, :]
    ta = (b * plan.threads + x).ravel()
    ta = ta[ta < ntemps * rows * k]
    rung = kernel_quotient(ta, rows * k, plan.rung_mul,
                           plan.rung_shr).astype(np.int64)
    t = ta - rung * rows * k
    r = kernel_quotient(t, k, plan.div_mul, plan.div_shr).astype(np.int64)
    return ta, rung, r, t - r * k


kinds = st.sampled_from([("words", None), ("words", 3), ("uniforms", None),
                         ("uniforms", 1), ("normals", None)])


@settings(max_examples=200, deadline=None)
@given(kinds, st.integers(1, 20_000), st.integers(1, 20),
       st.integers(0, 3), st.integers(1, 16))
@example(("words", 3), 256, 1, 0, 16)  # workload 4's shuffle keys
@example(("normals", None), 50_000, 3, 0, 1)  # the DIME stage
@example(("uniforms", None), 5003, 2, 1, 1)  # a tail of one
@example(("words", None), 7, 3, 0, 5)  # blocks spanning rungs
def test_draw_plan_visits_every_counter_once(kind_word, rows, k, cut,
                                             ntemps):
    kind, word = kind_word
    per_value = {"uniforms": 4, "normals": 2}.get(kind)
    every = word is None and per_value is not None
    d = max(1, per_value * k - cut % per_value) if every else k
    plan = draw_plan(kind, rows, k, d if every else None, word, ntemps)
    assert plan.threads == DRAW_THREADS and DRAW_THREADS % 32 == 0
    assert DRAW_THREADS <= DRAW_THREADS_LIMIT
    total = ntemps * rows * k
    assert plan.blocks == -(-total // plan.threads)
    ta, rung, r, j = walk(plan, rows, k, ntemps)
    assert np.array_equal(np.sort(ta), np.arange(total))
    assert np.all((0 <= rung) & (rung < ntemps))
    assert np.array_equal((rung * rows + r) * k + j, ta)
    assert np.all((0 <= j) & (j < k))
    # One vector store a counter only where every row is whole counters:
    # counter t's values are then elements [per_value t, per_value (t + 1))
    # of the rung's (rows, d) output, exactly its row's columns.
    assert plan.vec == int(every and d == per_value * k)
    if plan.vec:
        assert np.array_equal((rung * rows + r) * d + per_value * j,
                              per_value * ta)


def test_draw_plan_at_the_paths_shapes():
    """Workload 4's shuffle keys (16 rungs x 256 counters) run as 32
    blocks of 128 threads, two a rung; the DIME stage's normals (5e4 rows
    of 3 counters) as 1172 blocks of 128, each row stored whole."""
    w4 = draw_plan("words", 256, 1, None, 3, 16)
    assert (w4.threads, w4.blocks, w4.vec) == (128, 32, 0)
    dime = draw_plan("normals", 50_000, 3, 6, None, 1)
    assert (dime.threads, dime.blocks, dime.vec) == (128, 1172, 1)


def test_k2s_two_entry_points_share_one_library():
    """K2's tiled kernel and its rung kernel are one source, built once."""
    assert (_build._lib_path("accept_select")
            == _build._lib_path("accept_rungs"))
    assert _build.KERNELS["accept_rungs"][0] == "accept_select.cu"
