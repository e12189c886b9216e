"""Mean of the longest 5 % of every gap between consecutive output tokens of
a request in the window, each token timed by the host after the step that
returned it (a request's first two tokens come back from one step).  The
gaps that hold an admission are 2-3 % of all, so a percentile sits on one
admission's stall or on the step between them and plain decode gaps; the
mean of the longest 5 % takes every stall, weighted by its length."""
from readers import gaps_ms, top_mean


def read(run):
    return top_mean(gaps_ms(run), 0.05)
