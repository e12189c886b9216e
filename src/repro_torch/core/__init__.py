"""Plan, policy-hook and interval-metric data model of the PyTorch port
(port of ``src/repro/core/``, the parts the serving path reads)."""
