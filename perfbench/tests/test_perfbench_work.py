"""The yardstick's arithmetic against counts made by hand."""
import json
from pathlib import Path

import pytest

from perfbench.harness import work
from perfbench.reference.model import RefCfg

CONFIGS = Path(__file__).parents[1] / "configs"


def cfg(name):
    return RefCfg.from_config(json.loads((CONFIGS / f"{name}.json")
                                         .read_text()))


def test_peaks():
    assert work.PEAK_BF16 == 989e12 and work.HBM_BW == 3.35e12


def test_chameleon_gate_linear():
    # M=2048 rows (B=4, S=512), K=8192, N=22016, bf16 in and out
    m, k, n = 2048, 8192, 22016
    flops = 2 * m * k * n                       # 738,734,374,912
    byts = 2 * (m * k + k * n + m * n)          # 484,442,112
    assert flops == 738_734_374_912 and byts == 484_442_112
    assert work.gemm_s(m, k, n) == pytest.approx(flops / 989e12)
    # decode: 48 rows, bound by the weight's bytes
    assert work.gemm_s(48, k, n) == pytest.approx(
        2 * (48 * k + k * n + 48 * n) / 3.35e12)


def test_chameleon_params():
    c = cfg("chameleon-34b")
    layer = 8192 * 8192 * 2 + 8192 * 1024 * 2 + 3 * 8192 * 22016
    assert work.matmul_params(c) == 48 * layer + 8192 * 65536
    assert work.matmul_params(c) == 33_755_758_592


def test_granite_expert_group():
    c = cfg("granite-moe-3b-a800m")
    rows = 2048 * 8                      # every token's 8 choices
    one = 0.0
    for k, n in ((1536, 512), (1536, 512), (512, 1536)):
        flops = 2 * rows * k * n         # 25,769,803,776 each
        byts = 2 * (rows * k + rows * n + 40 * k * n)
        one += max(flops / 989e12, byts / 3.35e12)
    assert 2 * rows * 1536 * 512 == 25_769_803_776
    assert work._experts_s(c, 2048, backward=False) == pytest.approx(one)
    assert work._experts_s(c, 2048, backward=True) == pytest.approx(3 * one)
    per_token = 1536 * (1536 + 512 + 512 + 1536) + 1536 * 40 \
        + 8 * 3 * 1536 * 512
    assert work.matmul_params(c) == 32 * per_token + 1536 * 49155


def test_causal_attention():
    c = cfg("chameleon-34b")
    s = 3000
    # each layer: q·k and p·v over the s(s+1)/2 causal pairs, 64 heads
    # of 128: 2 products × 2 flops × 128 × 64 × 4,501,500
    pairs = s * (s + 1) // 2
    flops = 4 * 128 * 64 * pairs
    assert work.prefill_flops(c, s) == pytest.approx(
        2 * (work.matmul_params(c) - 8192 * 65536) * s + 2 * 8192 * 65536
        + 48 * flops)
    assert work.decode_flops(c, [9, 19]) == pytest.approx(
        2 * 2 * work.matmul_params(c) + 4 * 64 * 128 * 48 * (10 + 20))


def test_train_flops_three_forwards():
    c = cfg("chameleon-34b-4l")
    assert c.layers == 4
    fwd = 2 * work.matmul_params(c) * 2048 \
        + 4 * 64 * 128 * 4 * 4 * 512 * 513 / 2
    assert work.train_flops(c, 4, 512) == pytest.approx(3 * fwd)
