"""Flash-decode, contiguous and paged: CUDA kernels + plain versions (port of ``src/repro/kernels/flash_decode/``)."""
