"""Model FLOPs of the window's training steps (6 per parameter met and
trained token, and causal attention's products thrice; recomputation not
counted) over the window's seconds and the card's bf16 dense peak, in
percent; a traced run leaves out its profiled steps and the host time
they held."""
from perfbench.harness import work

LAYER = "whole step"
UNIT = "%"
MOVES = "train_tok_s"


def read(rec):
    steps = rec["steps"] - sum(s["name"] == "step" and s["profiled"]
                               for s in rec["spans"])
    flops = steps * work.train_flops(rec["ref"], rec["batch"], rec["seq"])
    seconds = rec["window_s"] - rec["traced_s"]
    return 100.0 * flops / (seconds * work.PEAK_BF16)
