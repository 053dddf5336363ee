"""Greedy tokens of the port's ServeSession under the ``hopper_sparse24``
backend and the ``fp8:sparse24`` policy against the JAX ServeSession (same
rule as test_torch_serve.py: exact in f32, exact up to a near-tie flip in
bf16).

``fp8:sparse24`` runs in bf16 only: packed weights ignore fp8 in the
reference (its matmul tests for a packed weight before the fp8 branch), and
this pair pins the port to that rule.
"""
import pytest

from test_torch_serve import check_tokens


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sparse24_primary_greedy_tokens_match_jax(dtype):
    check_tokens("bf16:sparse24:pallas_sparse24",
                 "bf16:sparse24:hopper_sparse24", True, dtype)


def test_fp8_sparse24_greedy_tokens_match_jax():
    check_tokens("fp8:sparse24:pallas", "fp8:sparse24:hopper", True, "bf16")
