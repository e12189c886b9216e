"""Training of the PyTorch port (port of ``src/repro/training/``): AdamW,
the synthetic data pipeline, checkpoints and the fault-tolerant loop."""
