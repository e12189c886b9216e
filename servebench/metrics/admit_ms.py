"""Host wall of the steps that admitted, per request admitted (prefill of
every admitted prompt, then the batch's decode), whole window, ms."""
from readers import step_ms


def read(run):
    return step_ms(run, admitting=True)
