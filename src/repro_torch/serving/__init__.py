"""Serving engine, engine pool, backends, fault injection and the shadow
twin of the PyTorch port (port of ``src/repro/serving/``)."""
