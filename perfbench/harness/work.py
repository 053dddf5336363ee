"""The yardstick's arithmetic: the card's peaks and the operations and
bytes the model's work needs, from the configuration file's sizes alone.

Peaks are a frozen copy of ``repro_torch/launch/roofline.py``'s
``PEAK_OPS_S["bf16"]`` and ``HBM_BW`` (commit 87e2085): one H100 SXM at
700 W, dense, from NVIDIA's data sheet. Model FLOPs follow that file's
``model_flops_estimate`` (2·N per served token, 6·N per trained token, N
the parameters a token meets in matrix products: every linear and the
head, the top-k experts of a routed layer, not the token table, which is
a lookup) and add causal attention's score and value products, which it
leaves out. Recomputation under checkpointing is not counted. A GEMM's
least time is ``max(2·M·K·N / peak, bytes / bandwidth)``, each operand
read once and the output written once, in bf16 (the head's logits in
f32).
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

PEAK_BF16 = 989e12
HBM_BW = 3.35e12
BF16 = 2
F32 = 4


def layer_linears(c) -> List[Tuple[str, int, int]]:
    """(name, K, N) of one layer's dense linears (not the experts)."""
    q, kv = c.heads * c.head_dim, c.kv_heads * c.head_dim
    out = [("q", c.d, q), ("k", c.d, kv), ("v", c.d, kv), ("o", q, c.d)]
    if not c.experts:
        out += [("gate", c.d, c.ff), ("up", c.d, c.ff), ("down", c.ff, c.d)]
    return out


def matmul_params(c) -> int:
    """Parameters a token meets in matrix products (head included)."""
    per = sum(k * n for _, k, n in layer_linears(c))
    if c.experts:
        per += c.d * c.experts + c.top_k * 3 * c.d * c.ff
    return c.layers * per + c.d * c.vocab


def prefill_flops(c, s: int) -> float:
    """One prompt of ``s`` tokens: every layer over every token, the head
    over the last one, and causal attention (position p sees p + 1)."""
    per_layer = 2.0 * (matmul_params(c) - c.d * c.vocab) * s
    return per_layer + 2.0 * c.d * c.vocab \
        + 4.0 * c.heads * c.head_dim * c.layers * s * (s + 1) / 2


def decode_flops(c, positions: Iterable[int]) -> float:
    """One token at each position: the whole model and attention over
    position + 1 keys."""
    pos = list(positions)
    return 2.0 * matmul_params(c) * len(pos) \
        + 4.0 * c.heads * c.head_dim * c.layers * sum(p + 1 for p in pos)


def train_flops(c, batch: int, seq: int) -> float:
    """One step: three times the forward (forward, two backward
    products) of every linear and of causal attention."""
    fwd = 2.0 * matmul_params(c) * batch * seq \
        + 4.0 * c.heads * c.head_dim * c.layers * batch * seq * (seq + 1) / 2
    return 3.0 * fwd


def gemm_s(m: int, k: int, n: int, out_bytes: int = BF16) -> float:
    """A GEMM's least time on the card."""
    if m <= 0:
        return 0.0
    return max(2.0 * m * k * n / PEAK_BF16,
               ((m * k + k * n) * BF16 + m * n * out_bytes) / HBM_BW)


def _experts_s(c, tokens: int, backward: bool) -> float:
    """The routed experts' three products, each as one group over the
    top-k rows of every token with every expert's weight moved once; the
    two backward products of each move the same bytes."""
    rows = tokens * c.top_k
    one = sum(max(2.0 * rows * k * n / PEAK_BF16,
                  (rows * k + rows * n + c.experts * k * n) * BF16 / HBM_BW)
              for k, n in ((c.d, c.ff), (c.d, c.ff), (c.ff, c.d)))
    return 3 * one if backward else one


def linears_s(c, rows: int, head_rows: int) -> float:
    """Least time of the linears of one forward over ``rows`` tokens, the
    head over ``head_rows`` of them."""
    t = c.layers * sum(gemm_s(rows, k, n) for _, k, n in layer_linears(c))
    if c.experts:
        t += c.layers * (gemm_s(rows, c.d, c.experts, F32)
                         + _experts_s(c, rows, backward=False))
    return t + gemm_s(head_rows, c.d, c.vocab, F32)


def train_linears_s(c, rows: int) -> float:
    """Least time of a training step's linears over ``rows`` tokens:
    each forward product and both backward ones (input and weight
    gradients) of every linear and of the head."""
    def three(m, k, n, out=BF16):
        return gemm_s(m, k, n, out) + gemm_s(m, n, k) + gemm_s(k, m, n)
    t = c.layers * sum(three(rows, k, n) for _, k, n in layer_linears(c))
    if c.experts:
        t += c.layers * (three(rows, c.d, c.experts, F32)
                         + _experts_s(c, rows, backward=True))
    return t + three(rows, c.d, c.vocab, F32)

