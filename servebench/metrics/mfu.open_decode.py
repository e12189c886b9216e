"""Useful model FLOPs of the window's decode-only steps (those that admitted
nothing) over their host wall at the bf16 peak, in %."""
from readers import mfu


def read(run):
    steps = [s for s in run.steps if not s.admitted]
    return mfu(run, steps, sum(s.t1 - s.t0 for s in steps))
