"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper computes its kernel's plain PyTorch version; these
tests hold those plain versions (and the wrappers' routing) against the JAX
kernels run in interpret mode, on the same numpy-seeded inputs. The CUDA
kernels themselves are held against the plain versions on the card by
test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fp8_matmul as fm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import registry

FP8 = [jnp.float8_e4m3fn, jnp.float8_e5m2]


def _mat(shape, seed, dtype, scale=4.0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    j = jnp.asarray(a * scale).astype(dtype)
    return j, bridge.to_torch(np.asarray(j))


# -- kernel A: the GEMM --------------------------------------------------------

@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (128, 128, 128, 128, 128, 128),
    (256, 512, 256, 128, 128, 128),
    (128, 256, 384, 64, 128, 256),
])
@pytest.mark.parametrize("dtype", FP8)
def test_plain_gemm_matches_pallas_kernel(m, k, n, bm, bn, bk, dtype):
    jx, tx = _mat((m, k), 0, dtype)
    jw, tw = _mat((k, n), 1, dtype)
    want = jops.fp8_matmul(jx, jw, out_dtype=jnp.float32, bm=bm, bn=bn, bk=bk)
    got = fm.fp8_matmul(tx, tw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("m,k,n", [(3, 24, 40), (1, 7, 5), (77, 40, 24)])
@pytest.mark.parametrize("dtype", FP8 + [jnp.bfloat16])
def test_plain_gemm_takes_ragged_shapes(m, k, n, dtype):
    """Shapes the Pallas kernel cannot tile; the port's kernel masks them."""
    jx, tx = _mat((m, k), 2, dtype)
    jw, tw = _mat((k, n), 3, dtype)
    want = jref.fp8_matmul_ref(jx, jw)
    got = fm.fp8_matmul(tx, tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(tref.fp8_matmul_ref(tx, tw).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-2)


def test_gemm_bf16_output_rounds_the_f32_sum():
    jx, tx = _mat((5, 64), 4, jnp.bfloat16, 1.0)
    jw, tw = _mat((64, 9), 5, jnp.bfloat16, 1.0)
    got = fm.fp8_matmul(tx, tw, torch.bfloat16)
    want = jref.fp8_matmul_ref(jx, jw, out_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2)


def test_hopper_backend_routes_cpu_tensors_to_the_plain_version():
    _, tx = _mat((2, 3, 32), 6, jnp.bfloat16, 1.0)
    _, tw = _mat((32, 16), 7, jnp.bfloat16, 1.0)
    before = fm.LAUNCHES
    be = registry.get_backend("hopper")
    out = be.dense(tx, tw, out_dtype=torch.float32)
    assert out.shape == (2, 3, 16)
    assert fm.LAUNCHES == before          # no kernel launch on the CPU
    want = fm.fp8_matmul_plain(tx.reshape(6, 32), tw).reshape(2, 3, 16)
    assert torch.equal(out, want)
    assert torch.equal(out, registry.get_backend("ref").dense(
        tx, tw, out_dtype=torch.float32))


def test_wrappers_refuse_tensors_off_cpu_and_cuda():
    """No silent plain path for a tensor that is not on the CPU."""
    x = torch.empty((4, 8), dtype=torch.bfloat16, device="meta")
    w = torch.empty((8, 4), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        fm.fp8_matmul(x, w)
    q = torch.empty((1, 2, 4, 32), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)


def test_sparse24_entries_name_the_later_slice():
    with pytest.raises(NotImplementedError, match="sparse24"):
        registry.get_backend("hopper").sparse24(None, None, None)


def test_hopper_backward_runs_the_reference():
    """The kernel is forward-only; gradients come from the torch path."""
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.normal(size=(3, 16)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(rng.normal(size=(16, 8)), dtype=torch.float32,
                     requires_grad=True)
    for precision in ("dense", "fp8"):
        grads = []
        for name in ("hopper", "torch"):
            be = registry.get_backend(name)
            fn = be.dense if precision == "dense" else be.fp8
            out = fn(x, w, out_dtype=torch.float32)
            gx, gw = torch.autograd.grad(out.square().sum(), (x, w))
            grads.append((out.detach(), gx, gw))
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", FP8)
def test_ops_fp8_matmul_dynamic_matches_jax(dtype):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 8, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    want = jops.fp8_matmul_dynamic(jnp.asarray(x), jnp.asarray(w),
                                   out_dtype=jnp.float32)
    got = tops.fp8_matmul_dynamic(torch.from_numpy(x), torch.from_numpy(w),
                                  out_dtype=torch.float32)
    assert got.shape == (2, 8, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-4)


# -- kernel B: flash attention --------------------------------------------------

def _qkv(b, s, h, kvh, hd, seed=8):
    rng = np.random.default_rng(seed)
    out = []
    for heads in (h, kvh, kvh):
        a = rng.normal(size=(b, s, heads, hd)).astype(np.float32)
        j = jnp.asarray(a).astype(jnp.bfloat16)
        out.append((j, bridge.to_torch(np.asarray(j))))
    return out


@pytest.mark.parametrize("b,h,kvh,s,hd,bq,bk", [
    (1, 4, 4, 128, 64, 64, 64),
    (2, 8, 2, 256, 64, 64, 128),
    (1, 4, 1, 128, 32, 128, 64),
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_pallas_kernel(b, h, kvh, s, hd, bq, bk, causal):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(b, s, h, kvh, hd)
    want = jops.flash_attention(jq, jk, jv, causal=causal, bq=bq, bk=bk)
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (b, s, h, hd) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("s", [77, 5])
def test_plain_flash_takes_ragged_lengths(s):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, s, 4, 2, 32, seed=10)
    want = jref.flash_attention_ref(
        jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
        jv.transpose(0, 2, 1, 3), causal=True).transpose(0, 2, 1, 3)
    got = tops.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


def test_flash_ref_keeps_the_bottom_right_mask():
    """ref.py's mask is bottom-right; the kernel's is top-left. The kernel
    wrapper refuses Sq != Skv under causal, where the two would differ."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 8, 2, 2, 32, seed=11)
    qt = tq.transpose(1, 2)[:, :, :3].contiguous()
    kt, vt = tk.transpose(1, 2).contiguous(), tv.transpose(1, 2).contiguous()
    want = jref.flash_attention_ref(jq.transpose(0, 2, 1, 3)[:, :, :3],
                                    jk.transpose(0, 2, 1, 3),
                                    jv.transpose(0, 2, 1, 3))
    np.testing.assert_allclose(
        tref.flash_attention_ref(qt, kt, vt).float().numpy(),
        np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)
    with pytest.raises(ValueError, match="Sq == Skv"):
        fa.flash_attention(qt, kt, vt, causal=True)
