"""Chain storage backends of the port."""

from .backend import Backend
from .device import DeviceBackend

__all__ = ["Backend", "DeviceBackend"]
