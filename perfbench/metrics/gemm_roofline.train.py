"""The least time of the linears of the profiled training step (each
forward product and both backward ones, with the experts' and the head's)
over the device time of the kernels classed GEMM in it, in percent. The
class holds the float32 reference backward's products and attention's,
which the program runs as library GEMMs."""
from perfbench.harness import work
from perfbench.harness.trace import class_seconds

LAYER = "kernels"
UNIT = "%"
MOVES = "train_tok_s"


def read(rec):
    st = rec.get("stretch")
    if st is None:
        return None
    need = st["steps"] * work.train_linears_s(rec["ref"],
                                              rec["batch"] * rec["seq"])
    took = class_seconds(st, "gemm")
    return 100.0 * need / took if took else None
