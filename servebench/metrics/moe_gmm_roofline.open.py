"""The traced steps' expert-FFN work at the roofline (``work.moe_step_bound_s``:
the experts their live tokens touch read once, their top-k products) over
the device time of the ``moe_gmm`` kernels, in %."""
import work
from readers import roofline


def read(run):
    if not run.dims["experts"]:
        return None
    def bound(s):
        live = sum(end - start for _, start, end in s.prefill) + len(s.decode_ctx)
        return work.moe_step_bound_s(run.layer, run.dims, live)
    return roofline(run, bound, "moe_gmm")
