"""The port's fp8 quantization gives the JAX package's bytes and scales."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fp8 as jfp8
from repro_torch import bridge
from repro_torch.core import fp8 as tfp8

DTYPES = [(jnp.float8_e4m3fn, tfp8.E4M3), (jnp.float8_e5m2, tfp8.E5M2)]


def _inputs(shape, seed, src_dtype):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    a[0, 0] = 7.5          # a clear amax
    j = jnp.asarray(a).astype(src_dtype)
    return j, bridge.to_torch(np.asarray(j))


@pytest.mark.parametrize("jd,td", DTYPES)
@pytest.mark.parametrize("src_dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", [(64, 96), (3, 40), (1, 257)])
def test_quantize_weight_static_is_bit_equal(jd, td, src_dtype, shape):
    j, t = _inputs(shape, 1, src_dtype)
    jq, jinv = jfp8.quantize_weight_static(j, jd)
    tq, tinv = tfp8.quantize_weight_static(t, td)
    assert tq.dtype == td and tinv.dtype == torch.float32
    assert bridge.to_numpy_bits(tq).tobytes() == \
        np.asarray(jq).view(np.uint8).tobytes()
    assert np.float32(tinv.item()).tobytes() == \
        np.asarray(jinv, np.float32).tobytes()


def test_all_zero_tensor_uses_the_amax_floor():
    z = np.zeros((4, 8), np.float32)
    jq, jinv = jfp8.quantize_weight_static(jnp.asarray(z))
    tq, tinv = tfp8.quantize_weight_static(torch.from_numpy(z))
    assert np.float32(tinv.item()) == np.asarray(jinv, np.float32)
    assert not bridge.to_numpy_bits(tq).any()


@pytest.mark.parametrize("lead", [(6,), (2, 3)])
def test_dynamic_fp8_matmul_matches_jax(lead):
    """Per-tensor activation amax over every row (all batch slots)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=lead + (48,)).astype(np.float32)
    w = (rng.normal(size=(48, 24)) * 0.2).astype(np.float32)
    want = jfp8.dynamic_fp8_matmul(jnp.asarray(x), jnp.asarray(w),
                                   out_dtype=jnp.float32)
    got = tfp8.dynamic_fp8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                  out_dtype=torch.float32)
    assert got.shape == lead + (24,)
    # identical fp8 operands and scales; f32 sums in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_fp8_dot_descales_like_jax():
    rng = np.random.default_rng(3)
    xq = jnp.asarray(rng.normal(size=(5, 32)) * 4).astype(jnp.float8_e4m3fn)
    wq = jnp.asarray(rng.normal(size=(32, 16)) * 4).astype(jnp.float8_e4m3fn)
    want = jfp8.fp8_dot(xq, wq, 0.5, 0.25, out_dtype=jnp.float32)
    got = tfp8.fp8_dot(bridge.to_torch(np.asarray(xq)),
                       bridge.to_torch(np.asarray(wq)), 0.5, 0.25,
                       out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-4)
