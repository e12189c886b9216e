"""Paged flash-decode: CUDA kernel + plain version (port of ``src/repro/kernels/flash_decode/``, paged path)."""
