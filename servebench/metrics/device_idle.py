"""Share of the traced slice's time with a request in the engine in which
no device operation ran, in %."""
from readers import device_idle


def read(run):
    return device_idle(run)
