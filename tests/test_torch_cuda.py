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


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 256, 1000), (77, 200, 72), (1, 8, 3)]
                         + SPLIT_AND_RAGGED)
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


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 77, 128, 200, 512])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_cuda_flash_kernel_matches_plain(s, hd, group):
    """Causal, two kv heads of ``group`` query heads each; ragged S masks a
    part tile. P is rounded to bf16 for P V: a few 1e-3 on outputs of order
    1, under 2e-2. A second call gives the same bits (no split, no
    atomics)."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((1, 2 * group, s, hd), generator=gen,
                    device="cuda").bfloat16()
    k = torch.randn((1, 2, s, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((1, 2, s, hd), generator=gen, device="cuda").bfloat16()
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
                                   (4, 4096, 1024), (128, 4096, 1024)])
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

def _lane_model():
    from repro_torch.configs import get_reduced
    from repro_torch.models import init_params
    from repro_torch.models.layers import RuntimeCfg
    cfg = get_reduced("llama3-8b")
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
def test_cuda_two_sessions_on_two_lanes_keep_their_bits():
    """Two sessions decoding at once, each on a lane (stream) of its own,
    give every token and logit bit of the two decoding one after the
    other."""
    _need_cuda()
    from repro_torch.core import concurrency as tcc
    cfg, params, rt = _lane_model()
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
