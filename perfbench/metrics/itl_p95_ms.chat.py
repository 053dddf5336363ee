"""95th percentile of the gaps between a request's consecutive output
tokens (the host clock when the call that made each returned), over every
gap in the window outside the profiled stretch."""
import numpy as np

LAYER = "continuous batching"
UNIT = "ms"
MOVES = "output_tok_s"


def read(rec):
    gaps = rec.get("itl_s") or []
    return 1e3 * float(np.percentile(gaps, 95)) if gaps else None
