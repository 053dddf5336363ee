"""The mixes' lengths and token ids: alike from one seed, different from
another, the same sizes in every seed's first blocks."""
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench.harness import traffic

MIXES = sorted(p.stem for p in (Path(__file__).parents[1] / "traffic")
               .glob("*.json")
               if json.loads(p.read_text())["kind"] == "serve_closed")


def mix(name):
    return json.loads((Path(__file__).parents[1] / "traffic"
                       / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    m = mix(name)
    a = traffic.requests(m, 3_000_000_017, 65536)[:50]
    b = traffic.requests(m, 3_000_000_017, 65536)[:50]
    assert [(len(x.prompt), x.max_new) for x in a] == \
        [(len(x.prompt), x.max_new) for x in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_order_same_sizes(name):
    m = mix(name)
    a = traffic.requests(m, 1, 65536)
    b = traffic.requests(m, 2, 65536)
    k = 4 * m["clients"]
    la = [(len(x.prompt), x.max_new) for x in a[:k]]
    lb = [(len(x.prompt), x.max_new) for x in b[:k]]
    assert la != lb
    assert sorted(la) == sorted(lb)
    assert not np.array_equal(a[0].prompt[:8], b[0].prompt[:8])


@pytest.mark.parametrize("name", MIXES)
def test_lengths_in_their_ranges(name):
    m = mix(name)
    pd = traffic.LengthDist(**m["prompt"])
    for lp, lo in traffic.lengths(m):
        assert m["prompt"]["lo"] <= lp <= pd.max
        assert m["output"]["lo"] <= lo <= m["output"]["hi"]
        assert lp + lo <= m["max_len"]


def test_length_dist_long_share():
    d = traffic.LengthDist(64, 512, 512, 768, 0.1)
    rng = np.random.default_rng(0)
    draws = [d.sample(rng) for _ in range(20000)]
    long = np.mean([x > 512 for x in draws])
    assert 0.08 < long < 0.12
    with pytest.raises(ValueError):
        traffic.LengthDist(0, 4)


def test_large_seeds():
    m = mix(MIXES[0])
    for seed in (0, 2**31 + 5, 2**40 + 3):
        assert len(traffic.requests(m, seed, 100)) == m["pool"]
