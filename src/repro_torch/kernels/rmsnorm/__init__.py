"""Fused RMSNorm: Triton kernel + plain version (port of ``src/repro/kernels/rmsnorm/``)."""
