"""Mean ``dispatch.launch`` span of the decode dispatches (the program's
recorder): the host time to enqueue one decode step's model ops and argmax,
ms.  None where the run holds no spans."""
from spans import decode_launch_ms


def read(run):
    return decode_launch_ms(run)
