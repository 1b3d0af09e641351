"""Proposal moves of the port: the stretch, DE, DE-snooker, walk and KDE
ensemble moves, and the Metropolis-Hastings and Gaussian moves."""

from .base import Move
from .de import DEMove
from .de_snooker import DESnookerMove
from .gaussian import GaussianMove
from .kde import KDEMove
from .mh import MHMove
from .red_blue import RedBlueMove
from .stretch import StretchMove
from .walk import WalkMove

__all__ = ["DEMove", "DESnookerMove", "GaussianMove", "KDEMove", "MHMove",
           "Move", "RedBlueMove", "StretchMove", "WalkMove"]
