"""Paged serving engine, engine pool and backend of the PyTorch port
(port of ``src/repro/serving/``)."""
