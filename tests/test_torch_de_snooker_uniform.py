"""The inverse K-S check of ``tests/integration/test_de_snooker.py`` on
the port's snooker move: a chain started uniform and sampling a normal
must fail a uniform K-S test."""

import torch

torch.set_num_threads(1)

from emcee_tpu_torch import moves
from tests.test_torch_sampler import _test_uniform


def test_uniform_de_snooker():
    _test_uniform(moves.DESnookerMove(), nsteps=4000)
