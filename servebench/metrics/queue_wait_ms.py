"""Mean, over the requests admitted in the window, of the time from a
request's due time to the start of its ``engine.admit`` span (the program's
recorder, host clock), ms: the wait in the queue, apart from the admission
itself.  None where the run holds no spans."""
from spans import queue_wait_ms


def read(run):
    return queue_wait_ms(run)
