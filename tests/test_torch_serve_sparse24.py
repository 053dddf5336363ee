"""Greedy tokens of the port's ServeSession under the sparse24 policies
against the JAX ServeSession (same rule as test_torch_serve.py: exact in
f32, exact up to a near-tie flip in bf16). Both sessions prune and pack the
bridged JAX init once, at construction. The ``pallas_sparse24`` and
``fp8:sparse24`` pairs are in test_torch_serve_sparse24_primary.py, to keep
each file well under a minute on the CPU.
"""
import pytest

from test_torch_serve import check_tokens


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("jspec,tspec,use_pallas", [
    ("bf16:sparse24:jnp", "bf16:sparse24:torch", False),
    ("bf16:sparse24:pallas", "bf16:sparse24:hopper", True),
])
def test_sparse24_greedy_tokens_match_jax(jspec, tspec, use_pallas, dtype):
    check_tokens(jspec, tspec, use_pallas, dtype)
