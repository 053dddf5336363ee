"""The least time of the linears that the profiled stretch's prefills and
decode steps needed (kernel A's work, whatever runs it) over the device
time of the kernels classed GEMM in the stretch, in percent. The class
holds decode attention's batched products too, which the program runs as
library GEMMs."""
from perfbench.harness import work
from perfbench.harness.trace import class_seconds

LAYER = "kernels"
UNIT = "%"
MOVES = "output_tok_s"


def read(rec):
    st = rec.get("stretch")
    if st is None:
        return None
    c = rec["ref"]
    need = sum(work.linears_s(c, n, 1) for n in st["admits"]) \
        + sum(work.linears_s(c, len(p), len(p)) for p in st["decodes"])
    took = class_seconds(st, "gemm")
    return 100.0 * need / took if took and need else None
