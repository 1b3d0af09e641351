"""Kernels and numerical building blocks of the port.

``stretch_kernel`` (K1) and ``accept_kernel`` (K2) hold each CUDA
kernel's wrapper beside its plain PyTorch version; ``philox`` is the
random stream both share; ``_build`` compiles ``csrc/*.cu`` on first use.
"""
