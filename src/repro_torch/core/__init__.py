"""Control plane of the PyTorch port (port of ``src/repro/core/``): the plan
data model, the policy program and schedulers, the roofline simulator, the
evaluation ladder's analytic rung, evolution and mutation, the two-plane
runtime and agentic scheduling."""
