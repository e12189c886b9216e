"""Grouped MoE SwiGLU: CUDA kernel + plain version (port of ``src/repro/kernels/moe_gmm/``)."""
