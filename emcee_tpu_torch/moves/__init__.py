"""Proposal moves of the port: the stretch, DE, DE-snooker, walk and KDE
ensemble moves, the Metropolis-Hastings and Gaussian moves, the
extension moves (side, blended, DE-Z, DIME, ensemble slice) and the
gradient moves (MALA, HMC, ChEES-HMC, ensemble MALA and HMC)."""

from .base import Move
from .blended import BlendedMove
from .de import DEMove
from .de_snooker import DESnookerMove
from .de_z import DEZMove
from .dime import DIMEMove
from .gaussian import GaussianMove
from .gradient import (
    ChEESHMCMove, EnsembleHMCMove, EnsembleMALAMove, HMCMove, MALAMove)
from .kde import KDEMove
from .mh import MHMove
from .red_blue import RedBlueMove
from .side import SideMove
from .slice import EnsembleSliceMove
from .stretch import StretchMove
from .walk import WalkMove

__all__ = ["BlendedMove", "ChEESHMCMove", "DEMove", "DESnookerMove",
           "DEZMove", "DIMEMove", "EnsembleHMCMove", "EnsembleMALAMove",
           "EnsembleSliceMove", "GaussianMove", "HMCMove", "KDEMove",
           "MALAMove", "MHMove", "Move", "RedBlueMove", "SideMove",
           "StretchMove", "WalkMove"]
