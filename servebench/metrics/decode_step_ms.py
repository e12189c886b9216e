"""Host wall of the steps that admitted nothing (one decode dispatch over
the batch), per step, whole window, ms."""
from readers import step_ms


def read(run):
    return step_ms(run, admitting=False)
