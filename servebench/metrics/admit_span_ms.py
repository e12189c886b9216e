"""Mean ``engine.admit`` span of the program's recorder: one request's own
prefix match, prefill dispatches and first token, ms (``admit_ms`` divides
whole admitting steps, neighbours' prefills and the decode included).  None
where the run holds no spans."""
from spans import admit_span_ms


def read(run):
    return admit_span_ms(run)
