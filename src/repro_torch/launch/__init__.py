"""Launch entry points of the PyTorch port (port of ``src/repro/launch/``)."""
