"""PyTorch / CUDA port of the Autopoiesis serving stack (``src/repro/``).

Laid out file for file like the JAX package it ports: ``configs``, ``core``,
``kernels/<name>``, ``models``, ``serving``, ``launch``.  It imports
``torch`` and never ``jax`` or anything of ``repro``: what it needs of the
JAX package's jax-free modules it keeps as its own copy.  Entry points run
on the CUDA card unless the caller passes ``device="cpu"``
(:mod:`repro_torch.device`).
"""
