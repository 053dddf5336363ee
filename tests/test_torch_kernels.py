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

from repro.core import sparsity as jsp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.core import sparsity as tsp
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fp8_matmul as fm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import registry
from repro_torch.kernels import sparse24_matmul as sm

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
    v = torch.empty((4, 4), dtype=torch.bfloat16, device="meta")
    m = torch.empty((1, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        sm.sparse24_matmul(x, v, m)
    with pytest.raises(ValueError):
        sm.block24_matmul(x, v, (0,), block=4)


def test_every_source_and_its_headers_are_in_csrc():
    """Each built source exists, has its C signatures, and every header it
    includes with quotes lies beside it in csrc/."""
    import re
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        for fn in _build.SIGNATURES[name]:
            assert f'extern "C" int {fn}(' in src, (name, fn)
        for header in re.findall(r'#include "([^"]+)"', src):
            assert (_build.CSRC / header).is_file(), (name, header)


def test_library_name_follows_source_and_headers(tmp_path, monkeypatch):
    """An edit to a source or to any csrc/*.cuh header renames the built
    library, so a stale one is never loaded."""
    (tmp_path / "k.cu").write_text('#include "t.cuh"\n')
    (tmp_path / "t.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("k")
    assert _build._target("k") == first
    (tmp_path / "t.cuh").write_text("// v2\n")
    second = _build._target("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "t.cuh"\n// edited\n')
    assert _build._target("k") not in (first, second)


def test_sparse24_entries_name_the_later_slice():
    """The sparse24 entry of every backend (a NotImplementedError until
    the packed GEMM was ported) computes the packed product now."""
    jx, tx = _mat((2, 5, 64), 20, jnp.bfloat16, 1.0)
    jw, tw = _mat((64, 24), 21, jnp.bfloat16, 1.0)
    jv, jm = jsp.pack_24(jsp.prune_24(jw))
    tv, tm = tsp.pack_24(tsp.prune_24(tw))
    want = jref.sparse24_matmul_ref(jx, jv, jm, out_dtype=jnp.float32)
    for name in ("ref", "torch", "hopper", "hopper_sparse24"):
        got = registry.get_backend(name).sparse24(tx, tv, tm,
                                                  out_dtype=torch.float32)
        assert got.shape == (2, 5, 24), name
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-4, err_msg=name)


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


# -- the autograd entries' backward ---------------------------------------------

def _normal(shape, seed, dtype):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(a).to(dtype)


def _grads(fn, x, w, g, wants):
    """``fn(x, w)`` and the gradients of the operands named in ``wants``
    at the cotangent ``g``, with the backward path counter's deltas."""
    a = x.clone().requires_grad_("x" in wants)
    b = w.clone().requires_grad_("w" in wants)
    out = fn(a, b)
    before = dict(registry.BACKWARD_PATHS)
    grads = torch.autograd.grad(out, [t for t in (a, b) if t.requires_grad],
                                g)
    paths = {k: n - before[k] for k, n in registry.BACKWARD_PATHS.items()}
    return out.detach(), grads, paths


def _torch_path(experts, out_dtype=torch.bfloat16):
    """The torch backend's product: autograd through the f32 reference."""
    one = registry.get_backend("torch").dense
    if not experts:
        return lambda a, b: one(a, b, out_dtype=out_dtype)
    return lambda a, b: torch.stack([one(a[e], b[e], out_dtype=out_dtype)
                                     for e in range(a.shape[0])])


def _before_its_own_backward(experts, out_dtype):
    """The hopper entry as it was before it had a backward of its own: the
    kernel forward, autograd through the f32 reference run again."""
    ref = _torch_path(experts, out_dtype)
    if experts:
        return lambda a, b: registry._fwd_with_ref_grad(
            lambda p, q: fm.fp8_matmul_batched(p, q, out_dtype), ref, a, b)

    def fn(a, b):
        a2 = a.reshape(-1, a.shape[-1])
        return registry._fwd_with_ref_grad(
            lambda p, q: fm.fp8_matmul(p, q, out_dtype), ref, a2,
            b).reshape(*a.shape[:-1], b.shape[-1])
    return fn


def _hopper_entry(experts, out_dtype=torch.bfloat16):
    if experts:
        return lambda a, b: registry.hopper_experts(a, b, out_dtype=out_dtype)
    be = registry.get_backend("hopper")
    return lambda a, b: be.dense(a, b, out_dtype=out_dtype)


# (x shape, w shape, operands that want a gradient, cotangent transposed)
BF16_BACKWARD_CASES = [
    ((64, 48), (48, 80), "xw", False),
    ((2, 5, 48), (48, 40), "xw", False),            # 3-D x, flattened
    ((13, 7), (7, 5), "xw", False),                 # ragged
    ((13, 24), (24, 40), "x", False),
    ((13, 24), (24, 40), "w", False),
    ((24, 16), (16, 40), "xw", True),               # non-contiguous g
    ((4, 32, 48), (4, 48, 24), "xw", False),        # expert-batched
    ((3, 7, 13), (3, 13, 5), "xw", False),          # experts, ragged
    ((4, 16, 24), (4, 24, 32), "x", True),
    ((4, 16, 24), (4, 24, 32), "w", False),
]


@pytest.mark.parametrize("xs,ws,wants,g_t", BF16_BACKWARD_CASES)
def test_bf16_backward_is_two_kernel_products(monkeypatch, xs, ws, wants,
                                              g_t):
    """A bf16 linear (and an expert-batched one) with a bf16 cotangent:
    backward is one kernel-A call per operand that wants a gradient (dX =
    g·wᵀ, dW = xᵀ·g; one batched call each for experts), counted on the
    kernel path, the gradients within one bf16 ulp of the largest entry of
    autograd's through the f32 reference."""
    experts = len(ws) == 3
    x, w = _normal(xs, 40, torch.bfloat16), _normal(ws, 41, torch.bfloat16)
    out_shape = (*xs[:-1], ws[-1])
    g = _normal(out_shape[:-2] + out_shape[:-3:-1], 42,
                torch.bfloat16).transpose(-1, -2) if g_t \
        else _normal(out_shape, 42, torch.bfloat16)
    assert g.is_contiguous() != g_t
    name = "fp8_matmul_batched" if experts else "fp8_matmul"
    calls, real = [], getattr(fm, name)

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(fm, name, counted)
    out, grads, paths = _grads(_hopper_entry(experts), x, w, g, wants)
    monkeypatch.undo()
    assert len(calls) == 1 + len(wants)
    assert paths == {"kernel": 1, "reference": 0}
    want_out, want, _ = _grads(_torch_path(experts), x, w, g, wants)
    assert torch.equal(out, want_out)
    for got, ref, op in zip(grads, want, wants):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape, op
        ulp = 2.0 ** -7 * float(ref.float().abs().max())
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=ulp, msg=op)


# (experts, operand dtype, output dtype): an f32 cotangent (the LM head's
# bf16 operands to f32 logits) or f32 operands
F32_BACKWARD_CASES = [
    (False, torch.bfloat16, torch.float32),
    (False, torch.float32, torch.float32),
    (False, torch.float32, torch.bfloat16),
    (True, torch.bfloat16, torch.float32),
    (True, torch.float32, torch.float32),
]


@pytest.mark.parametrize("experts,dtype,out_dtype", F32_BACKWARD_CASES)
@pytest.mark.parametrize("wants", ["xw", "x", "w"])
def test_f32_backward_is_bit_equal_to_the_reference_run_again(
        experts, dtype, out_dtype, wants):
    """An f32 cotangent or an f32 operand keeps the f32 reference's
    products, now taken directly: bit-equal to differentiating the
    reference run again, counted on the reference path, and no kernel
    call in backward."""
    xs, ws = ((3, 9, 24), (3, 24, 16)) if experts else ((2, 9, 24), (24, 16))
    x, w = _normal(xs, 43, dtype), _normal(ws, 44, dtype)
    g = _normal((*xs[:-1], ws[-1]), 45, out_dtype)
    out, grads, paths = _grads(_hopper_entry(experts, out_dtype), x, w, g,
                               wants)
    assert paths == {"kernel": 0, "reference": 1}
    want_out, want, _ = _grads(_before_its_own_backward(experts, out_dtype),
                               x, w, g, wants)
    assert torch.equal(out, want_out)
    assert all(a.dtype == b.dtype == dtype and torch.equal(a, b)
               for a, b in zip(grads, want))


def test_f32_backward_keeps_a_column_major_operand_bit_equal():
    """A column-major weight: autograd's mm backward takes its gradient by
    the transposed product; the direct products do the same."""
    x = _normal((6, 10), 46, torch.float32)
    w = _normal((8, 10), 47, torch.float32).t()
    g = _normal((6, 8), 48, torch.float32)
    _, grads, _ = _grads(_hopper_entry(False, torch.float32), x, w, g, "xw")
    _, want, _ = _grads(_before_its_own_backward(False, torch.float32), x,
                        w, g, "xw")
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


@pytest.mark.parametrize("entry", ["fp8", "fp8_experts", "sparse24"])
def test_fp8_and_sparse24_backward_differentiate_the_reference(entry):
    """The fp8 and 2:4 entries keep autograd through their reference: the
    gradients bit-equal to the torch backend's, counted on the reference
    path."""
    x = _normal((4, 8, 32), 49, torch.bfloat16)
    hopper, torch_be = (registry.get_backend(n) for n in ("hopper", "torch"))
    if entry == "sparse24":
        v, m = tsp.pack_24(tsp.prune_24(_normal((32, 16), 50,
                                                torch.bfloat16)))
        fns = [lambda a, b, be=be: be.sparse24(a, v, m) for be in
               (hopper, torch_be)]
        wants = "x"
    elif entry == "fp8":
        fns = [lambda a, b, be=be: be.fp8(a, b) for be in (hopper, torch_be)]
        wants = "xw"
    else:
        fns = [lambda a, b: registry.hopper_experts(a, b, precision="fp8"),
               lambda a, b: torch.stack([torch_be.fp8(a[e], b[e])
                                         for e in range(a.shape[0])])]
        wants = "xw"
    w = _normal((4, 32, 16) if entry == "fp8_experts" else (32, 16), 51,
                torch.bfloat16)
    g = _normal((4, 8, 16), 52, torch.bfloat16)
    (out, grads, paths), (want_out, want, _) = (
        _grads(fn, x, w, g, wants) for fn in fns)
    assert paths == {"kernel": 0, "reference": 1}
    assert torch.equal(out, want_out)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


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


# -- kernels D and E: packed 2:4 and block-2:4 GEMMs -----------------------------

@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (64, 512, 256)])
@pytest.mark.parametrize("vdtype", [jnp.bfloat16, jnp.float8_e4m3fn])
def test_plain_sparse24_matches_pallas_kernel(m, k, n, vdtype):
    """test_kernels.py's shapes and tolerance (rtol = atol = 2e-2: the
    Pallas kernel's f32 sums in another order, bf16 output)."""
    jx, tx = _mat((m, k), 22, jnp.bfloat16, 1.0)
    jw, tw = _mat((k, n), 23, vdtype, 1.0)
    jv, jm = jsp.pack_24(jsp.prune_24(jw))
    tv, tm = tsp.pack_24(tsp.prune_24(tw))
    want = jops.sparse24_matmul(jx, jv, jm, out_dtype=jnp.float32,
                                bm=64, bn=128, bk=128)
    got = sm.sparse24_matmul(tx, tv, tm, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-2, atol=2e-2)
    got16 = tops.sparse24_matmul(tx[None], tv, tm)
    assert got16.shape == (1, m, n) and got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16[0].float().numpy(), np.asarray(want),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("vdtype", [jnp.bfloat16, jnp.float8_e4m3fn,
                                    jnp.float8_e5m2])
def test_plain_sparse24_takes_ragged_shapes(vdtype):
    """M=3, N=40, K=24: no Pallas tile divides them; the port's kernel
    masks them."""
    jx, tx = _mat((3, 24), 24, jnp.bfloat16, 1.0)
    jw, tw = _mat((24, 40), 25, vdtype, 1.0)
    jv, jm = jsp.pack_24(jsp.prune_24(jw))
    tv, tm = tsp.pack_24(tsp.prune_24(tw))
    want = jref.sparse24_matmul_ref(jx, jv, jm, out_dtype=jnp.float32)
    got = sm.sparse24_matmul(tx, tv, tm, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(
        tref.sparse24_matmul_ref(tx, tv, tm, out_dtype=torch.float32).numpy(),
        np.asarray(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("block", [64, 32])
def test_plain_block24_matches_pallas_kernel(block):
    """test_kernels.py's test_block24_kernel (block 64), and block 32."""
    jx, tx = _mat((64, 512), 26, jnp.bfloat16, 1.0)
    jw, tw = _mat((512, 128), 27, jnp.bfloat16, 1.0)
    jwp, jkeep = jsp.prune_block24(jw, block=block)
    kept = tuple(int(i) for i in np.nonzero(np.asarray(jkeep))[0])
    jpacked = jnp.concatenate([jwp[i * block:(i + 1) * block] for i in kept])
    tpacked = bridge.to_torch(np.asarray(jpacked))
    want = jops.block24_matmul(jx, jpacked, kept, block=block,
                               out_dtype=jnp.float32)
    got = tops.block24_matmul(tx, tpacked, kept, block=block,
                              out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(
        tref.block24_matmul_ref(tx, tpacked, kept, block=block,
                                out_dtype=torch.float32).numpy(),
        np.asarray(jref.block24_matmul_ref(jx, jpacked, kept, block=block,
                                           out_dtype=jnp.float32)),
        rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError):
        sm.block24_matmul(tx, tpacked, kept[:-1], block=block)


def test_hopper_sparse24_routes_cpu_tensors_to_the_plain_version():
    _, tx = _mat((2, 3, 32), 28, jnp.bfloat16, 1.0)
    _, tw = _mat((32, 16), 29, jnp.bfloat16, 1.0)
    tv, tm = tsp.pack_24(tsp.prune_24(tw))
    before = (sm.LAUNCHES, sm.BLOCK24_LAUNCHES, fm.LAUNCHES)
    out = registry.get_backend("hopper").sparse24(tx, tv, tm,
                                                  out_dtype=torch.float32)
    primary = registry.get_backend("hopper_sparse24").dense(
        tx, tw, out_dtype=torch.float32)
    assert (sm.LAUNCHES, sm.BLOCK24_LAUNCHES, fm.LAUNCHES) == before
    want = sm.sparse24_matmul_plain(tx.reshape(6, 32), tv, tm,
                                    torch.float32).reshape(2, 3, 16)
    assert torch.equal(out, want) and torch.equal(primary, want)
    # a weight the packed format cannot hold takes the dense GEMM
    _, tw7 = _mat((28, 16), 30, jnp.bfloat16, 1.0)
    _, tx7 = _mat((3, 28), 31, jnp.bfloat16, 1.0)
    assert torch.equal(
        registry.get_backend("hopper_sparse24").dense(
            tx7, tw7, out_dtype=torch.float32),
        fm.fp8_matmul_plain(tx7, tw7))


def test_hopper_sparse24_backward_runs_the_reference():
    rng = np.random.default_rng(32)
    x = torch.tensor(rng.normal(size=(3, 16)), dtype=torch.float32,
                     requires_grad=True)
    tv, tm = tsp.pack_24(tsp.prune_24(torch.tensor(
        rng.normal(size=(16, 8)), dtype=torch.float32)))
    grads = []
    for name in ("hopper", "torch"):
        out = registry.get_backend(name).sparse24(x, tv, tm,
                                                  out_dtype=torch.float32)
        (gx,) = torch.autograd.grad(out.square().sum(), (x,))
        grads.append((out.detach(), gx))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


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
