"""Fused RMSNorm: CUDA kernel + plain version (port of ``src/repro/kernels/rmsnorm/``)."""
