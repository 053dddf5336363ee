"""Model FLOPs of the window's serving work (every prefill and every
decode step, attention's products included) over the window's seconds and
the card's bf16 dense peak, in percent; a traced run leaves out its
profiled stretches and the host time they held."""
from perfbench.harness import work

LAYER = "whole step"
UNIT = "%"
MOVES = "output_tok_s"


def read(rec):
    c = rec["ref"]
    flops = 0.0
    for s in rec["spans"]:
        if s["profiled"]:
            continue
        if s["name"] == "admit":
            flops += work.prefill_flops(c, s["tokens"])
        elif s["name"] == "decode":
            flops += work.decode_flops(c, s["positions"])
    seconds = rec["window_s"] - rec["traced_s"]
    return 100.0 * flops / (seconds * work.PEAK_BF16)
