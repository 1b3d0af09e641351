"""Proposal moves of the port: the stretch, DE and DE-snooker moves."""

from .base import Move
from .de import DEMove
from .de_snooker import DESnookerMove
from .red_blue import RedBlueMove
from .stretch import StretchMove

__all__ = ["DEMove", "DESnookerMove", "Move", "RedBlueMove", "StretchMove"]
