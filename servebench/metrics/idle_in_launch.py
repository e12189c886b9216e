"""Share of the traced slice's device idle time that falls inside
``dispatch.launch`` spans (their ``kernel.launch`` children included): the
device waiting while the host enqueues a model step, in %.  Idle gaps are put
on the host clock through the anchors; None where the run holds no spans
or no anchor."""
from spans import idle_share_inside


def read(run):
    return idle_share_inside(run, "dispatch.launch")
