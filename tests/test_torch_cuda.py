"""The CUDA kernels against their plain PyTorch versions, and sessions
decoding on lanes (CUDA streams), on the card.

Imports neither JAX nor the JAX package, so it runs on the machine with the
GPU: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``. Without a
CUDA device every test skips.
"""
import pytest
import torch

from repro_torch.core import execution as tex
from repro_torch.core import fp8 as tfp8
from repro_torch.core import sparsity as tsp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fp8_matmul as fm
from repro_torch.kernels import gemm_plan as gp
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import sparse24_matmul as sm


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


# Shapes whose plan splits K (decode and wide tiles), the wide (wgmma) tile
# at M = 128, and ragged M, N and K: with and without 16-byte aligned rows.
SPLIT_AND_RAGGED = [(4, 4096, 1024), (128, 4096, 1024), (77, 4000, 1000),
                    (33, 200, 72), (128, 1032, 136)]
# zamba2-1.2b's w_B / w_C / w_dt: N = 64, one tile wide, at decode and at a
# 512-token prefill
NARROW_N = [(4, 2048, 64), (512, 2048, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 256, 1000), (77, 200, 72), (1, 8, 3)]
                         + SPLIT_AND_RAGGED + NARROW_N)
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


def _same_bits(a, b):
    view = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


# A MoE layer's expert GEMMs (granite-moe-3b-a800m: 40 experts, d 1536,
# expert d_ff 512; capacity 1 at a 4-slot decode step, 32 and 20 at 128- and
# 77-token prefills), a split plan, and ragged members without aligned rows.
EXPERT_SHAPES = [(40, 1, 1536, 512), (40, 1, 512, 1536), (40, 32, 1536, 512),
                 (40, 20, 512, 1536), (2, 4, 4096, 1024), (3, 33, 200, 72)]


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,k,n", EXPERT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn,
                                   torch.float8_e5m2])
def test_cuda_batched_gemm_matches_plain(e, m, k, n, dtype):
    """One launch for every member; each member as the plain GEMM gives it;
    a member of zero rows (an expert no token reached) gives exact zeros;
    a second call gives the same bits."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((e, m, k), generator=gen, device="cuda")
    x[e // 2] = 0
    x = x.to(dtype)
    w = (torch.randn((e, k, n), generator=gen, device="cuda")
         * k ** -0.5).to(dtype)
    for out_dtype in (torch.float32, torch.bfloat16):
        before = fm.LAUNCHES
        got = fm.fp8_matmul_batched(x, w, out_dtype)
        assert fm.LAUNCHES == before + 1
        want = fm.fp8_matmul_batched_plain(x, w, out_dtype)
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-3)
        assert bool((got[e // 2] == 0).all())
        assert _same_bits(got, fm.fp8_matmul_batched(x, w, out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "fp8"])
def test_cuda_expert_matmul_is_each_expert_alone(precision):
    """``registry.hopper_experts`` against each expert through the hopper
    backend's own entry (its quantization per expert under fp8), with
    experts that received no token: finite, and zero there."""
    from repro_torch.kernels import registry
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((8, 5, 256), generator=gen, device="cuda")
    x[[1, 6]] = 0
    x = x.bfloat16()
    w = (torch.randn((8, 256, 128), generator=gen, device="cuda")
         * 256 ** -0.5).bfloat16()
    got = registry.hopper_experts(x, w, precision=precision)
    be = registry.get_backend("hopper")
    one = be.fp8 if precision == "fp8" else be.dense
    want = torch.stack([one(x[i], w[i]) for i in range(8)])
    assert bool(torch.isfinite(got.float()).all())
    assert bool((got[[1, 6]] == 0).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# granite-moe-3b-a800m's expert GEMMs in a train step at B=4, S=512: two
# groups of 1024 tokens, capacity 256 each, so 512 rows per expert
TRAIN_EXPERT_SHAPES = [(40, 512, 1536, 512), (40, 512, 512, 1536)]


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,k,n", TRAIN_EXPERT_SHAPES)
def test_cuda_expert_matmul_under_autograd_matches_the_torch_path(e, m, k,
                                                                   n):
    """``registry.hopper_experts`` forward (one launch of kernel A) and
    backward (two more: dX = g·wᵀ and dW = xᵀ·g, each batched over the
    experts) at the training shapes, against the ``torch`` backend's
    per-expert path (autograd through the f32 reference): the output and
    both operand gradients within kernel A's bf16 tolerance, and a repeat
    of the forward and backward bit-equal."""
    from repro_torch.kernels import registry
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((e, m, k), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((e, k, n), generator=gen, device="cuda")
         * k ** -0.5).bfloat16()
    g = torch.randn((e, m, n), generator=gen, device="cuda").bfloat16()

    def run(path):
        a, b = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        out = path(a, b)
        return (out.detach(), *torch.autograd.grad(out, (a, b), g))
    before = fm.BATCHED_LAUNCHES
    got = run(registry.hopper_experts)
    assert fm.BATCHED_LAUNCHES == before + 3
    want = run(lambda a, b: tex.matmul_experts(
        a, b, tex.parse_policy("bf16:dense:torch")))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), rtol=8e-3,
                                   atol=8e-3 * float(b.float().abs().max()))
    assert all(_same_bits(a, b)
               for a, b in zip(got, run(registry.hopper_experts)))


# llama4-scout's expert GEMMs (16 experts, d 5120, expert d_ff 8192, top 1):
# capacity 1 at a 4-slot decode step, 10 at a 128-token prefill, and two
# groups of 1024 tokens at capacity 80 in a train step at B=4, S=512
TOP1_EXPERT_SHAPES = [(16, 1, 5120, 8192), (16, 10, 8192, 5120),
                      (16, 160, 5120, 8192), (16, 160, 8192, 5120)]
# kernel A against its plain twin: max|err| / max|plain| (chip_smoke.py's
# GEMM_REL_TOL: f32 sums in another order, and one bf16 rounding either
# side)
GEMM_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,k,n", TOP1_EXPERT_SHAPES)
def test_cuda_top1_expert_gemm_matches_plain(e, m, k, n):
    """Kernel A's expert-batched launch at llama4-scout's widths against
    its plain twin, forward (both output types, one launch, an expert no
    token reached exactly zero) and under autograd
    (``registry.hopper_experts`` against the torch backend's per-expert
    path: the output and both operand gradients)."""
    from repro_torch.kernels import registry
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((e, m, k), generator=gen, device="cuda")
    x[e // 2] = 0
    x = x.bfloat16()
    w = (torch.randn((e, k, n), generator=gen, device="cuda")
         * k ** -0.5).bfloat16()
    for out_dtype in (torch.float32, torch.bfloat16):
        before = fm.LAUNCHES
        got = fm.fp8_matmul_batched(x, w, out_dtype)
        assert fm.LAUNCHES == before + 1
        want = fm.fp8_matmul_batched_plain(x, w, out_dtype)
        assert _rel(got, want) <= GEMM_REL_TOL[out_dtype]
        assert bool((got[e // 2] == 0).all())
    g = torch.randn((e, m, n), generator=gen, device="cuda").bfloat16()

    def run(path):
        a, b = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        out = path(a, b)
        return (out.detach(), *torch.autograd.grad(out, (a, b), g))
    got = run(registry.hopper_experts)
    want = run(lambda a, b: tex.matmul_experts(
        a, b, tex.parse_policy("bf16:dense:torch")))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.bfloat16
        assert _rel(a, b) <= GEMM_REL_TOL[torch.bfloat16]


# chameleon-34b's linears in a train step at B=4, S=512 (2048 rows, d 8192):
# q/o, k/v, gate/up, and down (K = 22016)
CHAMELEON_TRAIN_SHAPES = [(2048, 8192, 8192), (2048, 8192, 1024),
                          (2048, 8192, 22016), (2048, 22016, 8192)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", CHAMELEON_TRAIN_SHAPES)
def test_cuda_linear_backward_on_kernel_a_matches_the_reference(m, k, n):
    """The hopper dense entry forward and backward (dX = g·wᵀ and dW =
    xᵀ·g on kernel A: three launches in all) at chameleon-34b's training
    shapes, against the ``torch`` backend (autograd through the f32
    reference): the output and both gradients within GEMM_REL_TOL, and a
    repeat of the forward and backward bit-equal."""
    from repro_torch.kernels import registry
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((k, n), generator=gen, device="cuda")
         * k ** -0.5).bfloat16()
    g = torch.randn((m, n), generator=gen, device="cuda").bfloat16()

    def run(backend):
        a, b = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        out = registry.get_backend(backend).dense(a, b)
        return (out.detach(), *torch.autograd.grad(out, (a, b), g))
    before = fm.LAUNCHES
    got = run("hopper")
    assert fm.LAUNCHES == before + 3
    want = run("torch")
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape
        assert _rel(a, b) <= GEMM_REL_TOL[torch.bfloat16]
    assert all(_same_bits(a, b) for a, b in zip(got, run("hopper")))


# llama3-405b's down projection at decode and at a 128-token prefill (K =
# 53248: 832 steps of 64 along K) and its head (K = 16384, N = 128256:
# 2.10 G entries, 2.15% under 2^31), each output column checked
WIDEST = [(4, 53248, 16384), (128, 53248, 16384), (4, 16384, 128256)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", WIDEST)
def test_cuda_gemm_at_the_widest_shapes_matches_plain(m, k, n):
    """Kernel A at llama3-405b's widest K and largest operand against its
    plain twin in both output types (GEMM_REL_TOL over the whole output),
    one launch, and a second call bit-equal to the first."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((k, n), generator=gen, device="cuda")
         * k ** -0.5).bfloat16()
    for out_dtype in (torch.float32, torch.bfloat16):
        before = fm.LAUNCHES
        got = fm.fp8_matmul(x, w, out_dtype)
        assert fm.LAUNCHES == before + 1
        assert got.shape == (m, n) and bool(torch.isfinite(got).all())
        assert _rel(got, fm.fp8_matmul_plain(x, w, out_dtype)) \
            <= GEMM_REL_TOL[out_dtype]
        assert _same_bits(got, fm.fp8_matmul(x, w, out_dtype))


# (group, hd, s, kv heads): two kv heads at every S, head dim and group,
# zamba2-1.2b's shared-attention prefill (32 heads of 64, group 1),
# llama4-scout's (40 heads over 8 kv heads of 128: group 5),
# chameleon-34b's and deepseek-67b's (64 over 8: group 8) and
# llama3-405b's (128 over 8: group 16)
FLASH_CASES = [(g, hd, s, 2) for g in (1, 4, 8) for hd in (32, 64, 128, 256)
               for s in (1, 77, 128, 200, 512, 1040)] \
    + [(1, 64, 128, 32), (1, 64, 512, 32)] \
    + [(g, 128, s, 8) for g in (5, 8, 16) for s in (77, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "group,hd,s,kvh", FLASH_CASES,
    ids=[f"{g}-{hd}-{s}" + (f"-kvh{kvh}" if kvh != 2 else "")
         for g, hd, s, kvh in FLASH_CASES])
def test_cuda_flash_kernel_matches_plain(s, hd, group, kvh):
    """Causal, ``kvh`` kv heads of ``group`` query heads each; ragged S
    masks a part tile. P is rounded to bf16 for P V: a few 1e-3 on outputs
    of order 1, under 2e-2. A second call gives the same bits (no split,
    no atomics)."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((1, kvh * group, s, hd), generator=gen,
                    device="cuda").bfloat16()
    k = torch.randn((1, kvh, s, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((1, kvh, s, hd), generator=gen, device="cuda").bfloat16()
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, causal=True)
    assert fa.LAUNCHES == before + 1
    torch.testing.assert_close(got.float(),
                               fa.flash_attention_plain(q, k, v).float(),
                               rtol=2e-2, atol=2e-2)
    assert _same_bits(got, fa.flash_attention(q, k, v, causal=True))


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", [(77, 200), (128, 33), (1, 512)])
def test_cuda_flash_kernel_without_the_mask(sq, skv):
    """Non-causal, Sq != Skv: every query row sees every key."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn((2, 8, sq, 64), generator=gen, device="cuda").bfloat16()
    k = torch.randn((2, 2, skv, 64), generator=gen, device="cuda").bfloat16()
    v = torch.randn((2, 2, skv, 64), generator=gen, device="cuda").bfloat16()
    got = fa.flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(
        got.float(), fa.flash_attention_plain(q, k, v, causal=False).float(),
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


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 512, 1024), (77, 4000, 1000),
                                   (3, 24, 40), (128, 256, 384),
                                   (4, 4096, 1024), (128, 4096, 1024)]
                         + NARROW_N)
@pytest.mark.parametrize("vdtype", [torch.bfloat16, torch.float8_e4m3fn,
                                    torch.float8_e5m2])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_cuda_sparse24_kernel_matches_plain(m, k, n, vdtype, out_dtype):
    """Weights scaled by K^-0.5, so outputs are O(1). f32 output: both sum
    exact products in f32 and differ in order only (~1e-6); bf16 output
    adds one rounding either may take on the other side."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((k, n), generator=gen, device="cuda")
         * k ** -0.5).to(vdtype)
    values, meta = tsp.pack_24(tsp.prune_24(w))
    before = sm.LAUNCHES
    got = sm.sparse24_matmul(x, values, meta, out_dtype)
    assert sm.LAUNCHES == before + 1
    want = sm.sparse24_matmul_plain(x, values, meta, out_dtype)
    tol = 1e-4 if out_dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,block", [(4, 4096, 1024, 128),
                                         (77, 512, 1000, 64),
                                         (3, 96, 40, 12), (5, 64, 36, 8),
                                         (128, 4096, 1024, 128),
                                         (128, 1024, 520, 64)])
def test_cuda_block24_kernel_matches_plain(m, k, n, block):
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    w = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
    wp, keep = tsp.prune_block24(w, block)
    kept = tuple(int(i) for i in torch.nonzero(keep).flatten())
    packed = torch.cat([wp[i * block:(i + 1) * block] for i in kept])
    before = sm.BLOCK24_LAUNCHES
    got = sm.block24_matmul(x, packed, kept, block, torch.float32)
    assert sm.BLOCK24_LAUNCHES == before + 1
    torch.testing.assert_close(
        got, sm.block24_matmul_plain(x, packed, kept, block, torch.float32),
        rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("m,tile,splits", [(4, gp.SMALL, 1),
                                           (128, gp.DEEP, 1),
                                           (77, gp.DEEP, 1)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_cuda_block24_kernel_at_its_own_schedule(m, tile, splits, out_dtype):
    """Kernel E at llama3-8b's gate/up shape (K 4096, N 14336, blocks of
    128) on its own plan: unsplit Small at decode, the deep ring at
    prefill. Within 1e-4 (f32 out) or 8e-3 relative (bf16 out: one more
    rounding either may take) of its plain version, and bit-equal to a
    repeat."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((m, 4096), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((4096, 14336), generator=gen, device="cuda")
         * 4096 ** -0.5).bfloat16()
    wp, keep = tsp.prune_block24(w, 128)
    kept = tuple(int(i) for i in torch.nonzero(keep).flatten())
    packed = torch.cat([wp[i * 128:(i + 1) * 128] for i in kept])
    plan = gp.launch_plan(m, 14336, 2048, "block24", x.device)[0]
    assert (plan.tile, plan.splits) == (tile, splits)
    got = sm.block24_matmul(x, packed, kept, 128, out_dtype)
    want = sm.block24_matmul_plain(x, packed, kept, 128, out_dtype)
    if out_dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = (got.float() - want.float()).abs().max()
        assert err <= 8e-3 * want.float().abs().max()
    assert _same_bits(got, sm.block24_matmul(x, packed, kept, 128,
                                             out_dtype))


def _plain_and_kernel(kernel, m, k, n, gen):
    """(kernel call, plan) of kernel A, D or E on seeded inputs."""
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((k, n), generator=gen, device="cuda")
         * k ** -0.5).bfloat16()
    dev = x.device
    if kernel == "A":
        return (lambda: fm.fp8_matmul(x, w, torch.bfloat16),
                gp.launch_plan(m, n, k, "gemm", dev)[0])
    if kernel == "D":
        values, meta = tsp.pack_24(tsp.prune_24(w))
        return (lambda: sm.sparse24_matmul(x, values, meta, torch.float32),
                gp.launch_plan(m, n, k, "sparse24", dev)[0])
    wp, keep = tsp.prune_block24(w, 128)
    kept = tuple(int(i) for i in torch.nonzero(keep).flatten())
    packed = torch.cat([wp[i * 128:(i + 1) * 128] for i in kept])
    return (lambda: sm.block24_matmul(x, packed, kept, 128, torch.bfloat16),
            gp.launch_plan(m, n, k // 2, "block24", dev)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["A", "D", "E"])
@pytest.mark.parametrize("m,k,n", [(4, 4096, 1024), (128, 4096, 1024)])
def test_cuda_split_k_is_bit_repeatable(kernel, m, k, n):
    """Split-K sums its partials in a fixed order (no float atomics): two
    calls on the same inputs give the same bits, at plans that split K."""
    _need_cuda()
    call, plan = _plain_and_kernel(kernel, m, k, n,
                                   torch.Generator(device="cuda")
                                   .manual_seed(7))
    assert plan.splits > 1
    first = call()
    for _ in range(3):
        again = call()
        assert torch.equal(first.view(torch.int16 if first.element_size()
                                      == 2 else torch.int32),
                           again.view(torch.int16 if again.element_size()
                                      == 2 else torch.int32))


@pytest.mark.cuda
def test_cuda_pack_matches_the_cpu_bytes():
    _need_cuda()
    w = torch.randn((256, 96), generator=torch.Generator().manual_seed(5))
    for dt in (torch.float32, torch.bfloat16, torch.float8_e4m3fn):
        cpu = tex.pack_weight(w.to(dt))
        gpu = tex.pack_weight(w.to(dt).cuda())
        assert torch.equal(gpu.meta.cpu(), cpu.meta)
        assert torch.equal(gpu.values.cpu().view(torch.uint8),
                           cpu.values.view(torch.uint8))


def _paged_inputs(B, h, kvh, hd, ps, mp, dtype, seed, idle_last=True):
    """Pools of B*mp+1 pages; slot b owns pages in a shuffled order, the
    last slot none (an idle slot) unless ``idle_last`` is False."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pool = B * mp + 1
    q = torch.randn((B, h, hd), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((pool, ps, kvh, hd), generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn((pool, ps, kvh, hd), generator=gen,
                     device="cuda").to(dtype)
    perm = torch.randperm(pool - 1, generator=torch.Generator().manual_seed(
        seed)).to(torch.int32)
    pm = perm[:B * mp].reshape(B, mp).clone()
    if idle_last:
        pm[-1] = -1
    return q, kp, vp, pm.cuda()


# (dtype, hd, ps, lengths, group, table): "idle" tables leave the last slot
# without pages, "full" give every slot all of its pages ("edges" too, with
# lengths that end on a split boundary), "hole" also unmaps a page in the
# middle of slot 0's walk (its rows are masked)
PAGED_CASES = [
    (torch.float32, 16, 8, (13, 32, 1), 2, "idle"),
    (torch.bfloat16, 128, 16, (129, 78, 1, 0, 0), 4, "idle"),
    (torch.bfloat16, 128, 8, (64, 3, 0), 4, "idle"),
    (torch.bfloat16, 64, 32, (100, 256, 0), 4, "idle"),
    # lengths that end on a split boundary (4 x 8 x 512: splits of 64)
    (torch.bfloat16, 128, 16, (64, 128, 512, 448), 4, "edges"),
    (torch.bfloat16, 128, 8, (512, 512, 512, 512), 4, "full"),
    (torch.bfloat16, 128, 16, (512, 512, 512, 512), 4, "full"),
    (torch.bfloat16, 128, 32, (512, 512, 512, 512), 4, "full"),
    (torch.bfloat16, 128, 16, (300, 77, 1, 0), 16, "idle"),
    (torch.float32, 128, 16, (300, 200, 512, 9), 16, "hole"),
    (torch.bfloat16, 32, 12, (250, 37, 1), 4, "hole"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,ps,lengths,group,table", PAGED_CASES)
def test_cuda_paged_decode_kernel_matches_plain(dtype, hd, ps, lengths,
                                                group, table):
    """Rows with no valid position (an idle slot, a length of 0) give 0 on
    both sides. f32 pools: JAX's own tolerance, 2e-5; bf16 pools: both
    sides sum the same bf16 values in f32 in another order, 1e-4. The
    splits are folded in a fixed order: a second call gives the same
    bits."""
    _need_cuda()
    B = len(lengths)
    mp = max(1, -(-max(lengths) // ps))
    kvh = 2 if hd == 16 or dtype == torch.float32 else 8
    h = kvh * group
    q, kp, vp, pm = _paged_inputs(B, h, kvh, hd, ps, mp, dtype, seed=6,
                                  idle_last=table == "idle")
    if table == "idle" and lengths[-1] == 0 and B > 3:
        pm[-2, 1:] = -1           # a slot with a page but length 0
    if table == "hole":
        pm[0, mp // 2] = -1
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    plan = pa.launch_plan(B, h, kvh, hd, mp * ps, q.device)[0]
    if table == "edges":
        assert plan.splits > 1
        assert all(n % plan.span == 0 for n in lengths[:3])
    before = pa.LAUNCHES
    got = pa.paged_flash_decode(q, kp, vp, pm, ln)
    assert pa.LAUNCHES == before + 1
    want = pa.paged_flash_decode_plain(q, kp, vp, pm, ln)
    tol = 2e-5 if dtype == torch.float32 else 1e-4
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    empty = torch.tensor([n == 0 for n in lengths], device="cuda")
    assert (got[empty] == 0).all()
    assert _same_bits(got, pa.paged_flash_decode(q, kp, vp, pm, ln))


def _split_call(kernel, seed):
    """A split launch of kernel A (decode gate/up), D (its decode gate/up)
    or C (the serving shape) on seeded inputs, as a closure."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if kernel == "C":
        q, kp, vp, pm = _paged_inputs(4, 32, 8, 128, 16, 32, torch.bfloat16,
                                      seed)
        ln = torch.tensor((129, 78, 1, 0), dtype=torch.int32, device="cuda")
        assert pa.launch_plan(4, 32, 8, 128, 512, q.device)[0].splits > 1
        return lambda: pa.paged_flash_decode(q, kp, vp, pm, ln)
    call, plan = _plain_and_kernel(kernel, 4, 4096, 14336, gen)
    assert plan.splits > 1
    return call


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["A", "D", "C"])
def test_cuda_split_launches_on_two_streams_keep_their_bits(kernel):
    """Two split launches in flight at once on two streams, several times
    over: each stream has its own workspace and counters, so every output
    is bit-equal to the same call made alone."""
    _need_cuda()
    calls = [_split_call(kernel, seed) for seed in (11, 12)]
    alone = [call() for call in calls]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(8):
        for i, (s, call) in enumerate(zip(streams, calls)):
            with torch.cuda.stream(s):
                outs[i].append(call())
    torch.cuda.synchronize()
    for want, got in zip(alone, outs):
        assert all(_same_bits(g, want) for g in got)


# ---------------------------------------------------------------------------
# Lanes: sessions and the speculative draft on CUDA streams
# ---------------------------------------------------------------------------

def _lane_model(arch="llama3-8b"):
    from repro_torch.configs import get_reduced
    from repro_torch.models import init_params
    from repro_torch.models.layers import RuntimeCfg
    cfg = get_reduced(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, init_params(cfg, gen, device="cuda"), \
        RuntimeCfg(use_pallas=True)


def _lane_session(cfg, params, rt, uids, **kw):
    import numpy as np
    from repro_torch.runtime.serve_loop import Request, ServeSession
    sess = ServeSession(params, cfg, batch_slots=2, max_len=64, rt=rt,
                        policy="bf16:dense:hopper", device="cuda", **kw)
    for uid in uids:
        rng = np.random.default_rng(uid)
        prompt = rng.integers(0, cfg.vocab_size, 5 + uid).astype(np.int32)
        sess.admit(Request(uid=uid, prompt=prompt, max_new=12))
    return sess


@pytest.mark.cuda
def test_cuda_lane_runs_its_thunk_on_its_stream():
    _need_cuda()
    from repro_torch.core import concurrency as tcc
    lane = tcc.ExecutionLane("l0")
    assert lane.device.type == "cuda" and lane.stream is not None
    seen = []
    x = torch.ones(256, 256, device="cuda")
    h = lane.dispatch(lambda: seen.append(torch.cuda.current_stream())
                      or x @ x)
    assert seen == [lane.stream]
    assert torch.cuda.current_stream() != lane.stream
    assert torch.equal(h.join(), torch.full((256, 256), 256.0,
                                            device="cuda"))
    assert h.event is not None and h.event.query()
    rep = tcc.characterize_streams(lambda i: (lambda: x @ x), 4)
    assert rep.n_streams == 4 and len(rep.per_stream_s) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-1.2b"])
def test_cuda_two_sessions_on_two_lanes_keep_their_bits(arch):
    """Two sessions decoding at once, each on a lane (stream) of its own,
    give every token and logit bit of the two decoding one after the
    other; zamba2-1.2b's steps replace their recurrent state leaves."""
    _need_cuda()
    from repro_torch.core import concurrency as tcc
    cfg, params, rt = _lane_model(arch)
    alone = []
    for uids in ((0, 1), (2, 3)):
        sess = _lane_session(cfg, params, rt, uids)
        logits = []
        while sess.n_active:
            sess.decode_once()
            logits.append(sess.last_logits.clone())
        alone.append(({r.uid: r.out for r in sess.completed}, logits))
    a = _lane_session(cfg, params, rt, (0, 1))
    b = _lane_session(cfg, params, rt, (2, 3))
    lanes = [tcc.ExecutionLane(f"lane{i}") for i in range(2)]
    together = [[], []]
    while a.n_active or b.n_active:
        tickets = [s.dispatch_decode(ln, overlap_group=0)
                   for s, ln in zip((a, b), lanes)]
        for i, (s, t) in enumerate(zip((a, b), tickets)):
            s.join_decode(t)
            if t.handle is not None:
                together[i].append(s.last_logits.clone())
    for (want_tok, want_logits), sess, got in zip(alone, (a, b), together):
        assert {r.uid: r.out for r in sess.completed} == want_tok
        assert len(got) == len(want_logits)
        assert all(_same_bits(g, w) for g, w in zip(got, want_logits))


@pytest.mark.cuda
@pytest.mark.parametrize("speculative", [None, {
    "k": 2, "draft_policy": "fp8:dense:hopper"}], ids=["plain", "spec"])
def test_cuda_state_leaves_outlive_a_slow_lane(speculative):
    """A step replaces each recurrent state leaf as it is enqueued, so the
    old leaf (made on the caller's stream) loses its last reference while
    the lane has not read it yet. With the lane held back (~1 s, longer
    than the host takes to enqueue a step) and the caller's stream filling
    fresh blocks of the same sizes with NaN, the tokens and logits are
    still those of the undisturbed run: the allocator may not hand the
    old leaves' blocks out before the lane is done. Only the first step's
    leaves come from the caller's stream (admission); later ones are the
    lane's own. The verify runs k = 2 steps: with three, the launches
    queued behind the held lane fill the stream's queue, the host waits
    for the lane at the third step's launches, and the lane has read the
    old leaves before the caller's stream gets to them."""
    _need_cuda()
    from repro_torch.core import concurrency as tcc
    from repro_torch.models.transformer import state_layers
    cfg, params, rt = _lane_model("zamba2-1.2b")
    kw = {} if speculative is None else {"speculative": speculative}
    calm = _lane_session(cfg, params, rt, (0, 1), **kw)
    want = []
    while calm.n_active:
        calm.decode_once()
        want.append(calm.last_logits.clone())
    sess = _lane_session(cfg, params, rt, (0, 1), **kw)
    lane = tcc.ExecutionLane("slow")
    got = []
    while sess.n_active:
        shapes = [t.shape for c in state_layers(sess.caches, cfg)
                  for t in c.values()]
        if not got:
            lane.dispatch(lambda: torch.cuda._sleep(2_000_000_000))
        t = sess.dispatch_decode(lane)
        junk = [torch.full(sh, float("nan"), device="cuda")
                for sh in shapes for _ in range(32)]
        sess.join_decode(t)
        del junk
        got.append(sess.last_logits.clone())
    assert {r.uid: r.out for r in sess.completed} == \
        {r.uid: r.out for r in calm.completed}
    assert len(got) == len(want)
    assert all(_same_bits(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("draft", ["bf16:dense:hopper", "fp8:dense:hopper"])
def test_cuda_speculative_draft_on_its_own_lane_gives_the_plain_stream(
        draft):
    """The draft chain runs on the session's draft lane and writes the
    cache in place; the verify's stream waits on the draft's event, so the
    committed tokens are the plain greedy stream."""
    _need_cuda()
    cfg, params, rt = _lane_model()
    plain = _lane_session(cfg, params, rt, (0, 1))
    plain.run()
    spec = _lane_session(cfg, params, rt, (0, 1),
                         speculative={"k": 3, "draft_policy": draft})
    while spec.n_active:
        t = spec.dispatch_decode()
        if t.spec_k > 1:
            assert t.draft_handle.event is not None
            assert t.draft_handle.lane == "draft" != t.lane
        spec.join_decode(t)
    assert {r.uid: r.out for r in spec.completed} == \
        {r.uid: r.out for r in plain.completed}
    assert spec.spec_totals[""]["steps"] > 0


@pytest.mark.cuda
def test_cuda_sampler_equals_the_cpu():
    """``core/prng.py`` on the card at a decode step's (slots, Vp) of
    llama3-8b: bits and uniforms bit-equal to the CPU's (which the CPU
    tests hold to ``jax.random``), categorical draws and the step's token
    choice the CPU's index but at a near-tie (top-2 margin under 1e-5 of
    the perturbed logits), Gumbel noise within torch.log's last bits."""
    _need_cuda()
    import numpy as np
    from repro_torch.core import prng
    from repro_torch.runtime.serve_loop import next_tokens
    key = prng.split(prng.PRNGKey(0))[1]
    shape = (4, 128256)
    assert torch.equal(prng.random_bits(key, shape, "cuda").cpu(),
                       prng.random_bits(key, shape, "cpu"))
    assert _same_bits(prng.uniform(key, shape, device="cuda").cpu(),
                      prng.uniform(key, shape, device="cpu"))
    g_cpu = prng.gumbel(key, shape, "cpu")
    assert (prng.gumbel(key, shape, "cuda").cpu() - g_cpu).abs().max() \
        <= 2e-6
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn(shape, generator=gen, device="cuda") * 3
    inv = float(np.float32(1) / np.float32(0.7))
    for got, want, rows in (
            (prng.categorical(key, logits), prng.categorical(
                key, logits.cpu()), logits.cpu() + g_cpu),
            (next_tokens(logits, 0.7, key)[:, 0],
             next_tokens(logits.cpu(), 0.7, key)[:, 0],
             logits.cpu() * inv + g_cpu)):
        top2 = torch.topk(rows, 2).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-5
        assert torch.equal(got.cpu()[clear], want[clear])


@pytest.mark.cuda
def test_cuda_sampled_sessions_on_two_lanes_keep_their_tokens():
    """Two sampled sessions decoding at once on lanes of their own draw
    the tokens of the two decoding one after the other: each key is split
    on the host at dispatch and its draw made on the lane's stream."""
    _need_cuda()
    from repro_torch.core import concurrency as tcc
    cfg, params, rt = _lane_model()
    kw = [dict(temperature=0.7, seed=s) for s in (1, 2)]
    alone = []
    for uids, k in zip(((0, 1), (2, 3)), kw):
        sess = _lane_session(cfg, params, rt, uids, **k)
        sess.run()
        alone.append({r.uid: r.out for r in sess.completed})
    a = _lane_session(cfg, params, rt, (0, 1), **kw[0])
    b = _lane_session(cfg, params, rt, (2, 3), **kw[1])
    lanes = [tcc.ExecutionLane(f"lane{i}") for i in range(2)]
    while a.n_active or b.n_active:
        tickets = [s.dispatch_decode(ln, overlap_group=0)
                   for s, ln in zip((a, b), lanes)]
        for s, t in zip((a, b), tickets):
            s.join_decode(t)
    for want, sess in zip(alone, (a, b)):
        assert {r.uid: r.out for r in sess.completed} == want
