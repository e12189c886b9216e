"""Dense paged model of the PyTorch port (port of ``src/repro/models/``)."""
