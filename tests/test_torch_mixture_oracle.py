"""The statistical oracle of ``tests/integration/test_mixture.py`` on the
port: the DE 0.8 + snooker 0.2 mixture with the reference defaults, in
the blocked roll configuration, and drawn once per ``mixture_block`` of
4 kept steps.  A file of its own so that the slow runs spread over test
workers."""

import torch

torch.set_num_threads(1)

from emcee_tpu_torch import moves
from tests.test_torch_sampler import _test_normal


def test_de_snooker_mixture():
    _test_normal([(moves.DEMove(), 0.8), (moves.DESnookerMove(), 0.2)],
                 ndim=3, nsteps=3000)


def test_de_snooker_mixture_blocked_roll():
    _test_normal(
        [(moves.DEMove(pair_mode="roll", randomize_split=False), 0.8),
         (moves.DESnookerMove(pair_mode="roll", randomize_split=False), 0.2)],
        ndim=3, nsteps=3000,
    )


def test_mixture_block_schedule():
    _test_normal(
        [(moves.DEMove(pair_mode="roll", randomize_split=False), 0.8),
         (moves.DESnookerMove(pair_mode="roll", nsplits=2,
                              randomize_split=False), 0.2)],
        ndim=3, nsteps=3000, mixture_block=4,
    )
