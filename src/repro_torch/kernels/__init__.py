"""Hand-written Hopper kernels of the PyTorch port (port of ``src/repro/kernels/``).

Each ``<name>/`` holds ``ref.py`` (plain PyTorch version), ``kernel.py``
(launcher of the CUDA C++ kernel) and ``ops.py`` (the public op:
kernel for CUDA tensors, plain version for CPU tensors).
"""
import torch


def no_grad_on_card(name: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when autograd would record a card
    kernel that has no gradient yet (ROADMAP queue 1 item 10's remainder):
    on the CPU the plain versions differentiate, on the card such a kernel
    never falls back to its plain version."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise NotImplementedError(
            f"{name}: no gradient on the card yet (ROADMAP queue 1 item 10, "
            f"remainder); train this family on the CPU")
