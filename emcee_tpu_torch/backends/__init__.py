"""Chain storage backends of the port."""

from . import pt
from .backend import Backend
from .device import DeviceBackend
from .hdf import HDFBackend, TempHDFBackend
from .pt import PTBackend, PTDeviceBackend, PTHDFBackend

__all__ = [
    "Backend",
    "DeviceBackend",
    "HDFBackend",
    "PTBackend",
    "PTDeviceBackend",
    "PTHDFBackend",
    "TempHDFBackend",
    "get_test_backends",
    "pt",
]


def get_test_backends():
    """Backends to parametrize tests over (reference
    ``backends/__init__.py``): the HDF one where h5py is installed."""
    backends = [Backend, DeviceBackend]
    try:
        import h5py  # noqa: F401
    except ImportError:
        return backends
    return backends + [TempHDFBackend]
