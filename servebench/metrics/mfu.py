"""Useful model FLOPs of the window's steps over the time with at least one
request in the engine at the bf16 peak, in % (``work.py`` counts them)."""
from readers import mfu


def read(run):
    return mfu(run, run.steps, run.engine_busy_s)
