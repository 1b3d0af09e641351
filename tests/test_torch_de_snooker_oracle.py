"""The statistical oracle of ``tests/integration/test_de_snooker.py`` on
the port's snooker move with the reference defaults (random picks,
nsplits=4), on the CPU.  A file of its own so that the slow runs spread
over test workers."""

import torch

torch.set_num_threads(1)

from emcee_tpu_torch import moves
from tests.test_torch_sampler import _test_normal


def test_normal_de_snooker():
    _test_normal(moves.DESnookerMove(), nsteps=4000)
