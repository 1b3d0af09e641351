"""More of the statistical oracle of ``test_torch_sampler.py``: four
split groups in 3-D, and the inverse K-S check on a uniform start.  A
file of its own so that the slow runs spread over test workers."""

import torch

torch.set_num_threads(1)

from emcee_tpu_torch import moves
from tests.test_torch_sampler import _test_normal, _test_uniform


def test_nsplits_stretch_ndim():
    _test_normal(moves.StretchMove(nsplits=4), ndim=3, nwalkers=32)


def test_uniform_stretch_roll():
    _test_uniform(moves.StretchMove(pair_mode="roll"))
