"""Greedy tokens of the port's ServeSession under the fp8 policies against
the JAX ServeSession (same rule as test_torch_serve.py: exact in f32, exact
up to a near-tie flip in bf16)."""
import pytest

from test_torch_serve import check_tokens


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("jspec,tspec,use_pallas", [
    ("fp8:dense:jnp", "fp8:dense:torch", False),
    ("fp8:dense:pallas", "fp8:dense:hopper", True),
])
def test_fp8_greedy_tokens_match_jax(jspec, tspec, use_pallas, dtype):
    check_tokens(jspec, tspec, use_pallas, dtype)
