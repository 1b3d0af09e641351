"""Proposal moves of the port: the stretch, DE, DE-snooker, walk and KDE
ensemble moves, the Metropolis-Hastings and Gaussian moves, and the
extension moves (side, blended, DE-Z, DIME, ensemble slice)."""

from .base import Move
from .blended import BlendedMove
from .de import DEMove
from .de_snooker import DESnookerMove
from .de_z import DEZMove
from .dime import DIMEMove
from .gaussian import GaussianMove
from .kde import KDEMove
from .mh import MHMove
from .red_blue import RedBlueMove
from .side import SideMove
from .slice import EnsembleSliceMove
from .stretch import StretchMove
from .walk import WalkMove

__all__ = ["BlendedMove", "DEMove", "DESnookerMove", "DEZMove", "DIMEMove",
           "EnsembleSliceMove", "GaussianMove", "KDEMove", "MHMove", "Move",
           "RedBlueMove", "SideMove", "StretchMove", "WalkMove"]
