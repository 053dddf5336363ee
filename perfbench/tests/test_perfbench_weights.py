"""Seeded weights: the same seed draws the same tree, another seed another;
each leaf at its scale; ``leaf_init`` draws them again bit for bit."""
import pytest
import torch

import small
from perfbench.harness import weights


def tree(conf, seed, chunk=None):
    from repro_torch.models.transformer import params_shape
    if chunk:
        weights.CHUNK, old = chunk, weights.CHUNK
    try:
        return weights.make(params_shape(small.arch(conf)), seed,
                            torch.device("cpu"))
    finally:
        if chunk:
            weights.CHUNK = old


@pytest.mark.parametrize("conf", [small.DENSE, small.MOE],
                         ids=["dense", "moe"])
def test_same_seed_same_weights_other_seed_other(conf):
    a, la = tree(conf, 2**40 + 1)
    b, _ = tree(conf, 2**40 + 1)
    c, _ = tree(conf, 2**40 + 2)
    from repro_torch.core.tree import leaves
    for x, y, z, lf in zip(leaves(a), leaves(b), leaves(c), la):
        assert torch.equal(x, y)
        if lf.scale:
            assert not torch.equal(x, z)
            assert x.data_ptr() % 16 == 0
            assert float(x.float().std()) == pytest.approx(lf.scale, rel=0.3)
        else:
            assert not x.any()


def test_leaf_init_draws_the_same_bits():
    params, leaves = tree(small.MOE, 99, chunk=1000)
    from repro_torch.core.tree import leaves as flat
    got = [torch.zeros(lf.shape, dtype=lf.dtype).reshape(-1)
           for lf in leaves]
    seen = [0] * len(leaves)

    def visit(i, lo, part):
        got[i][lo:lo + part.numel()] = part
        seen[i] += part.numel()
    old, weights.CHUNK = weights.CHUNK, 1000
    try:
        weights.leaf_init(leaves, 99, torch.device("cpu"), visit)
    finally:
        weights.CHUNK = old
    for t, g, n, lf in zip(flat(params), got, seen, leaves):
        if lf.scale:
            assert n == t.numel()
            assert torch.equal(t.reshape(-1), g)
