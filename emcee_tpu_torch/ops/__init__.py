"""Kernels and numerical building blocks of the port.

``stretch_kernel`` (K1), ``accept_kernel`` (K2), ``de_kernel`` (K5a) and
``snooker_kernel`` (K5b) hold each CUDA kernel's wrapper beside its plain
PyTorch version; ``philox`` is the random stream they share; ``_build``
compiles ``csrc/*.cu`` on first use.
"""
