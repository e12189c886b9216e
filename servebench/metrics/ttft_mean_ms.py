"""Mean, over every request due in the window, of the host time from its
due time to the end of the step that returned its first token; a request
with no token by the window's close enters at close - due, so a stall
raises it and is never dropped.  A mean and not a tail: a window holds a
few tens of chat requests, too few for a high percentile to have ten
requests beyond it."""
from readers import ttft_ms


def read(run):
    t = ttft_ms(run)
    return sum(t) / len(t) if t else None
