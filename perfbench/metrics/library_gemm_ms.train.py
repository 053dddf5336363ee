"""Device milliseconds per training step in GEMM kernels that are not the
port's own (the library's: today the float32 reference backward's and
attention's products), from the profiled step."""
from perfbench.harness.trace import class_seconds

LAYER = "training step"
UNIT = "ms"
MOVES = "train_tok_s"


def read(rec):
    st = rec.get("stretch")
    if st is None:
        return None
    return 1e3 * class_seconds(st, "gemm", "library") / st["steps"]
