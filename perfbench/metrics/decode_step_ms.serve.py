"""Mean host time of a decode step (``ServeSession.decode_once``, which
ends in the tokens' ``.cpu()``), over the window's steps outside the
profiled stretch."""
LAYER = "continuous batching"
UNIT = "ms"
MOVES = "output_tok_s"


def read(rec):
    d = [s["t1"] - s["t0"] for s in rec["spans"]
         if s["name"] == "decode" and not s["profiled"]]
    return 1e3 * sum(d) / len(d) if d else None
