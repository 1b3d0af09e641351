"""K5b's row sums in the kernel's order (``emcee_tpu_torch/ops/
snooker_kernel.py`` ``row_sum``, as ``csrc/snooker_propose.cu`` sums a
row): held bit for bit against a numpy float32 loop written in that exact
order, and to 1e-5 relative against ``torch.sum``, for ndim 1-200.  The
kernel is held against the plain version on the card by
``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from emcee_tpu_torch.ops.snooker_kernel import row_sum, snooker_propose_plain

torch.set_num_threads(1)


def loop_sum(terms):
    """The kernel's order, one float32 addition at a time: lane ``l``
    adds its 4-float chunks ``l, l+32, ...`` (each ``((a+b)+c)+d``, the
    floats past ``ndim`` +0.0) to +0.0, then lane ``l`` adds lane ``l ^ o``
    for ``o`` = 16, 8, 4, 2, 1; every lane ends with the total."""
    terms = np.asarray(terms, np.float32)
    n, nd = terms.shape
    zero = np.zeros(n, np.float32)

    def term(e):
        return terms[:, e] if e < nd else zero

    lanes = []
    for lane in range(32):
        acc = zero.copy()
        for c in range(lane, -(-nd // 4), 32):
            a, b, cc, d = (term(4 * c + j) for j in range(4))
            acc = acc + (((a + b) + cc) + d)
        lanes.append(acc)
    for o in (16, 8, 4, 2, 1):
        lanes = [lanes[lane] + lanes[lane ^ o] for lane in range(32)]
    assert all(np.array_equal(v, lanes[0]) for v in lanes)
    return lanes[0]


@pytest.mark.parametrize("nds", [range(1, 41), range(41, 129),
                                 range(129, 201)])
def test_row_sum_is_the_kernels_order(nds):
    rng = np.random.default_rng(nds.start)
    for nd in nds:
        # Terms of mixed sign and scale, a zero row and a row of -0.0.
        terms = (rng.normal(size=(6, nd))
                 * 10.0 ** rng.integers(-6, 6, size=(6, nd)))
        terms[4] = 0.0
        terms[5] = -0.0
        terms = terms.astype(np.float32)
        got = row_sum(torch.from_numpy(terms)).numpy()
        assert got.dtype == np.float32
        want = loop_sum(terms)
        assert np.array_equal(got, want), nd
        assert np.array_equal(np.signbit(got), np.signbit(want)), nd
        close = np.abs(terms).sum(1, dtype=np.float64) * 1e-5
        ref = torch.sum(torch.from_numpy(terms), dim=-1).numpy()
        assert (np.abs(got - ref) <= np.maximum(close, 1e-30)).all(), nd


def test_a_zero_norm_stays_in_its_own_row():
    """A walker at z itself (norm 0) gives NaN in its own row only: the
    sums pad their terms with +0.0, so no other row sees the 0 / 0."""
    coords = torch.randn(16, 5)
    coords[9] = coords[1]  # roll u4 = 0: walker 1 of split 1 has z = row 1
    u4 = torch.zeros(4)
    q, f = snooker_propose_plain(coords, 1, 2, gammas=1.7, ndim_global=5,
                                 pair_mode="roll", u4=u4)
    bad = ~torch.isfinite(f)
    assert bad.tolist() == [i == 1 for i in range(8)]
    assert torch.isfinite(q[~bad]).all()
