"""More of the DE oracle (``tests/integration/test_de.py``): three
dimensions, and the inverse K-S check on a uniform start."""

import torch

torch.set_num_threads(1)

from emcee_tpu_torch import moves
from tests.test_torch_sampler import _test_normal, _test_uniform


def test_uniform_de():
    _test_uniform(moves.DEMove())


def test_normal_de_3d():
    _test_normal(moves.DEMove(), ndim=3)
