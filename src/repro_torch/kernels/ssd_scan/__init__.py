"""Mamba-2 SSD chunked scan: CUDA kernel + plain version (port of ``src/repro/kernels/ssd_scan/``)."""
