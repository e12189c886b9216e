"""The traced steps' decode attention at the roofline
(``work.decode_attn_bound_s``: every live lane's cached K/V read once) over
the device time of the paged decode kernels (``decode_split``), in %."""
import work
from readers import roofline


def read(run):
    if "kv_heads" not in run.dims:
        return None
    return roofline(run, lambda s: work.decode_attn_bound_s(run.dims, s.decode_ctx),
                    "decode_split")
