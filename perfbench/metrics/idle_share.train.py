"""Share of the profiled stretch in which no operation ran on the device:
one minus the union of the device records over the stretch's length, both
on the profiler's clock, in percent."""
from perfbench.harness.trace import union_s

LAYER = "device"
UNIT = "%"
MOVES = "train_tok_s"


def read(rec):
    st = rec.get("stretch")
    if st is None:
        return None
    busy = union_s((a, b) for _, a, b in st["kernels"])
    return 100.0 * (1.0 - busy / st["wall_s"])
