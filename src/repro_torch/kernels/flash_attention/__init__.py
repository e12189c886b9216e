"""Flash attention: CUDA kernel + plain version (port of ``src/repro/kernels/flash_attention/``)."""
