"""The statistical oracle of ``tests/integration/test_de.py`` on the
port's DE move (reference defaults), on the CPU.  A file of its own so
that the slow runs spread over test workers."""

import torch

torch.set_num_threads(1)

from emcee_tpu_torch import moves
from tests.test_torch_sampler import _test_normal


def test_normal_de():
    _test_normal(moves.DEMove())


def test_normal_de_no_gamma():
    _test_normal(moves.DEMove(gamma0=1.0))
