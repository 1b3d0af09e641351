"""Proposal moves of the port (this slice: the stretch move family)."""

from .base import Move
from .red_blue import RedBlueMove
from .stretch import StretchMove

__all__ = ["Move", "RedBlueMove", "StretchMove"]
