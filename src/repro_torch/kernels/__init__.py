"""Hand-written Hopper kernels of the PyTorch port (port of ``src/repro/kernels/``).

Each ``<name>/`` holds ``ref.py`` (plain PyTorch version), ``kernel.py``
(launcher of the CUDA C++ kernel) and ``ops.py`` (the public op:
kernel for CUDA tensors, plain version for CPU tensors).
"""
