"""Distributed-serving helpers (port of ``src/repro/distributed/``)."""
