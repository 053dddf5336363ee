"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor the JAX package, so it runs on the machine with the
GPU: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``. Without a
CUDA device every test skips.
"""
import pytest
import torch

from repro_torch.core import fp8 as tfp8
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fp8_matmul as fm


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 256, 1000), (77, 200, 72), (1, 8, 3)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn,
                                   torch.float8_e5m2])
def test_cuda_gemm_kernel_matches_plain(m, k, n, dtype):
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    w = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
    before = fm.LAUNCHES
    got = fm.fp8_matmul(x, w)
    assert fm.LAUNCHES == before + 1
    torch.testing.assert_close(got, fm.fp8_matmul_plain(x, w),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [128, 77, 1])
def test_cuda_flash_kernel_matches_plain(s):
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((1, 8, s, 128), generator=gen, device="cuda").bfloat16()
    k = torch.randn((1, 2, s, 128), generator=gen, device="cuda").bfloat16()
    v = torch.randn((1, 2, s, 128), generator=gen, device="cuda").bfloat16()
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, causal=True)
    assert fa.LAUNCHES == before + 1
    torch.testing.assert_close(got.float(),
                               fa.flash_attention_plain(q, k, v).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_cuda_quantization_matches_the_cpu_bytes():
    _need_cuda()
    w = torch.randn((64, 96), generator=torch.Generator().manual_seed(2))
    for dt in (tfp8.E4M3, tfp8.E5M2):
        cq, cinv = tfp8.quantize_weight_static(w, dt)
        gq, ginv = tfp8.quantize_weight_static(w.cuda(), dt)
        assert torch.equal(gq.cpu().view(torch.uint8), cq.view(torch.uint8))
        assert torch.equal(ginv.cpu(), cinv)
