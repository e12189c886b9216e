"""95th percentile of the requests waiting for a slot (the engines' queues
and the pool's backlog), sampled before every round of the window."""
from readers import percentile


def read(run):
    return percentile([float(q) for q in run.queue], 0.95)
