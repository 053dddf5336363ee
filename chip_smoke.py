"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc/`` with
``nvcc``, holds each kernel against its plain PyTorch version at the shapes
the serving path gives it, then serves llama3-8b at its published width
through ``repro_torch.runtime.serve_loop.ServeSession`` under
``bf16:dense:hopper``, ``fp8:dense:hopper`` and ``bf16:sparse24:hopper``
(weights pruned and packed 2:4 once, at session set-up), with random
weights made on the card from a seed. Each policy's run is checked against
the ``torch`` backend (library matmul, chunked attention, the unpack-then-
matmul packed product): the first prefill's logits and the first decode
step's (the torch step run on a copy of the same state) within LOGIT_TOL,
and a full torch-backend run of the same requests whose greedy tokens may
first differ from the hopper run's only at a near-tie (top-2 margin under
twice LOGIT_TOL). ``bf16:dense:hopper`` is served a second time from a
paged cache (32 pages of 16 rows, a quarter of the dense cache), whose
greedy tokens must equal the dense run's exactly. A profiled decode step
gives the device's busy time and idle share. Then speculative decoding
(``ServeSession(speculative=...)``, ``bf16:dense:hopper`` verify) in three
arms, a bf16 draft (k=4, every draft accepted), an ``fp8:dense:hopper``
draft (k=4, kernel A in e4m3) and, paged, an ``fp8:sparse24:hopper`` draft
(k=2, kernel D), each with greedy tokens equal to the plain run's and its
launches counted per verify and draft step. A ``[streams]`` phase runs
split launches of kernels A, D and C on two streams at once, bit-equal to
the same calls made alone. Kernels C (paged flash
decode) and E (block-2:4) are on no serving path, as in the reference:
their entry points (``kernels.paged_attention.paged_decode_attention`` and
``sweep_paged_tilings``, ``kernels.ops.block24_matmul``) are driven at
their phases' shapes, and C also on the paged run's live pools.

Then the multi-tenant runtime on the same weights. ``[concurrency]`` runs
the paper's Fig 4/5 on CUDA streams (``characterize_streams`` over 1, 2, 4
and 8 lanes, serial and async, each stream running kernel A at the decode
k/v and gate/up shapes) and profiles one async round. ``[runtime]`` serves
three tenants through ``ServingRuntime`` with a ``bf16:dense:hopper`` and a
``bf16:sparse24:hopper`` partition (one lane, one stream, each), lane
overlap on (run A) and off (run B) in turns, against a plain
``ServeSession`` of each partition's policy; then two dense partitions
with a live ``migrate`` mid-flight (run C) against the same run without
it, and one ``WorkloadTrace`` replayed with overlap on and off. Tokens must
be equal across all of them, every request complete, the launches of A, B
and D equal the counts the partitions' steps imply, and the exported
Chrome traces validate.

Every kernel is timed by its device time (torch.profiler) with its
operands out of L2 (rotating copies where they total less than its 50 MB),
checked against its plain version and for bit-equal repeats, and prints its
plan: the tile and K splits of A, D and E, the grid of B, the splits of C's
page walk. B and C are timed beside SDPA, whose CUDA-event means are kept
as a second column. ``--kernels-only [--src DIR/src]`` runs just that, on
this checkout or another, so that two commits' kernels can be timed by the
same code in one call.

Prints one ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, when there is no CUDA device, when the port's sources are
missing, or when any phase fails. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
# Serving run (ISSUE: 4 slots, max_len 512, 8 requests of 128 and 77 tokens).
SLOTS, MAX_LEN, N_REQUESTS, MAX_NEW = 4, 512, 8, 16
PROMPT_LENS = (128, 77)
# hopper-vs-torch logit tolerance, in logit units (the logits are ~N(0, 1)
# at this init). Both backends accumulate in f32 and differ only in
# summation order, but activations are rounded to bf16 (8 mantissa bits)
# after every linear, so a one-ulp difference at one layer propagates
# through 32 layers: 0.09-0.11 measured on the H100. Under fp8 such a
# one-ulp move can carry an activation across an e4m3 rounding boundary
# (a step of 2^-4, not 2^-8), and the shared per-tensor amax spreads it to
# every element: 0.49 measured at the first prefill, so 1.0.
LOGIT_TOL = {"bf16": 0.15, "fp8": 1.0}

# H100 SXM data-sheet peaks (dense): bytes/s and operations/s per type
# (f32 outside the tensor cores).
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "e4m3": 1979e12, "e5m2": 1979e12,
              "f32": 67e12}


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# The H100's L2 cache. A kernel whose operands total less than this is timed
# over rotating copies of them (cold_ms), so that each call reads them from
# device memory, as a serving step does: it streams 15 GB of weights, which
# never stay in L2.
L2_BYTES = 50 * 2**20


def cold_ms(fn, operands, iters: int):
    """Device ms per call of ``fn(*operands)`` with the operands out of L2:
    where they total less than L2_BYTES, the calls rotate through enough
    copies of them to exceed twice L2. The time is the kernels' own
    (``device_ms``), so a call that the host issues more slowly than the
    card runs it is still timed as the card runs it. Returns (ms, copies)."""
    n_bytes = sum(t.numel() * t.element_size() for t in operands)
    n = 1 if n_bytes >= L2_BYTES else -(-2 * L2_BYTES // n_bytes) + 1
    sets = [tuple(operands)] + [tuple(t.clone() for t in operands)
                                for _ in range(n - 1)]
    turn = iter(range(1 << 62))

    def call():
        return fn(*sets[next(turn) % n])

    for _ in range(5):  # a profile now and then misses kernels
        ms = device_ms(call, iters)
        if ms > 0:
            return ms, n
    fail("torch.profiler missed kernels in five profiles of one call")


def host_us(fn, calls: int = 100) -> float:
    """Host microseconds per call of ``fn`` issued back to back (the device
    runs behind; a synchronise before and after)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / calls


def bit_equal(a, b) -> bool:
    """The same bits (``torch.equal`` would take -0.0 for +0.0)."""
    import torch
    view = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def plan_note(M, N, K, kind) -> str:
    """The tile and K splits the planner gives this shape (kernels/
    gemm_plan.py), or a note where the checkout under test has none."""
    import torch
    try:
        from repro_torch.kernels import gemm_plan
    except ImportError:
        return "no planner in this checkout"
    return gemm_plan.launch_plan(M, N, K, kind,
                                 torch.device("cuda", 0))[0].describe()


def device_ms(fn, iters: int = 50) -> float:
    """Mean device time per call of ``fn``: the summed durations of the
    kernels it launches, from torch.profiler over ``iters`` calls (after
    one warm-up call). Unlike ``time_ms`` it leaves out the gaps in which
    the device waits for the host to issue the next call. Every call
    launches the same kernels, so a profile in which some kernel was not
    recorded a whole number of times per call lost events: it gives 0, and
    ``cold_ms`` profiles again."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    counts = collections.Counter(e.name for e in kernels)
    if any(n % iters for n in counts.values()):
        return 0.0
    return sum(e.time_range.end - e.time_range.start for e in kernels) \
        / 1e3 / iters


def bound_ms(n_bytes: float, n_ops: float, kind: str):
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = n_ops / PEAK_OPS_S[kind]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


# ---------------------------------------------------------------------------
# Kernel A: the GEMM against its plain version
# ---------------------------------------------------------------------------

# (label, M, K, N): llama3-8b's projections at decode (M = slots: gate/up,
# q/o, k/v, down and the LM head) and at prefill (M = 128, and the ragged
# 77 of the second prompt length), and a ragged K.
GEMM_SHAPES = (
    ("decode_mlp", 4, 4096, 14336),
    ("decode_qo", 4, 4096, 4096),
    ("decode_kv", 4, 4096, 1024),
    ("decode_down", 4, 14336, 4096),
    ("decode_head", 4, 4096, 128256),
    ("prefill_mlp", 128, 4096, 14336),
    ("prefill_qo", 128, 4096, 4096),
    ("prefill_kv", 128, 4096, 1024),
    ("prefill_down", 128, 14336, 4096),
    ("prefill_ragged", 77, 4096, 14336),
    ("ragged_k", 77, 4000, 1000),
)
GEMM_TYPES = ("bf16", "e4m3", "e5m2")
# kernel-vs-plain tolerance on max|err| / max|plain|: both accumulate exact
# products in f32 and differ only in summation order (~1e-6 relative); a
# bf16 output adds one rounding, 2^-8 relative, that the two may take on
# either side.
GEMM_REL_TOL = {"float32": 1e-4, "bfloat16": 8e-3}


def gemm_inputs(M, K, N, kind, gen):
    import torch
    from repro_torch.core import fp8 as fp8lib
    x = torch.randn((M, K), generator=gen, device="cuda")
    w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
    if kind == "bf16":
        return x.to(torch.bfloat16), w.to(torch.bfloat16)
    dt = fp8lib.E4M3 if kind == "e4m3" else fp8lib.E5M2
    return (fp8lib.quantize_weight_static(x, dt)[0],
            fp8lib.quantize_weight_static(w, dt)[0])


def gemm_phase():
    import torch
    from repro_torch.kernels import fp8_matmul as fm
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for label, M, K, N in GEMM_SHAPES:
        plan = plan_note(M, N, K, "gemm")
        print(f"[gemm] {label} M={M} K={K} N={N}: plan {plan}", flush=True)
        for kind in GEMM_TYPES:
            x, w = gemm_inputs(M, K, N, kind, gen)
            for out_dtype in (torch.float32, torch.bfloat16):
                got = fm.fp8_matmul(x, w, out_dtype)
                again = fm.fp8_matmul(x, w, out_dtype)
                want = fm.fp8_matmul_plain(x, w, out_dtype)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                name = str(out_dtype).split(".")[-1]
                rel = err / max(scale, 1e-30)
                same = bit_equal(got, again)
                ok = bool(torch.isfinite(got).all()) and \
                    rel <= GEMM_REL_TOL[name] and same
                print(f"[gemm] {label} M={M} K={K} N={N} {kind}->{name}: "
                      f"max_abs_err={err:.3e} rel={rel:.2e} repeat "
                      f"bit-equal={same} {'ok' if ok else 'MISMATCH'}",
                      flush=True)
                if not ok:
                    fail(f"GEMM {label} {kind}->{name} disagrees with its "
                         f"plain version (rel {rel:.2e}) or with itself "
                         f"(bit-equal {same})")
            # times at the output type the main path uses there
            out_dtype = torch.float32 if (label == "decode_head"
                                          or kind != "bf16") \
                else torch.bfloat16
            ebytes = 2 if kind == "bf16" else 1
            obytes = 4 if out_dtype == torch.float32 else 2
            err = (fm.fp8_matmul(x, w, out_dtype).float()
                   - fm.fp8_matmul_plain(x, w, out_dtype).float()
                   ).abs().max().item()
            iters = 20 if N > 20000 else 50
            ms, copies = cold_ms(lambda a, b: fm.fp8_matmul(a, b, out_dtype),
                                 (x, w), iters)
            plain = time_ms(lambda: fm.fp8_matmul_plain(x, w, out_dtype), 5)
            lib, lib_note = None, None
            if kind == "bf16":
                lib = cold_ms(torch.matmul, (x, w), iters)[0]
            elif kind == "e4m3":
                lib, lib_note = scaled_mm_ms(x, w, out_dtype, iters)
            else:
                lib_note = "torch._scaled_mm has no e5m2 x e5m2 form"
            bms, by = bound_ms(M * K * ebytes + K * N * ebytes
                               + M * N * obytes, 2.0 * M * N * K, kind)
            row = {"label": label, "M": M, "K": K, "N": N, "type": kind,
                   "out": str(out_dtype).split(".")[-1], "max_abs_err": err,
                   "ms": ms, "plain_ms": plain, "library_ms": lib,
                   "library_note": lib_note, "bound_ms": bms,
                   "bound_by": by, "plan": plan, "operand_copies": copies}
            if M <= 16:
                row["host_us_per_call"] = host_us(
                    lambda: fm.fp8_matmul(x, w, out_dtype))
            rows.append(row)
            print(f"[gemm-time] {json.dumps(row)}", flush=True)
            del x, w
    return rows


def scaled_mm_ms(x_q, w_q, out_dtype, iters):
    """``torch._scaled_mm`` on e4m3 operands with unit scales: M padded to
    a multiple of 16 and B made column-major outside the timed region.
    Returns (ms, note)."""
    import torch
    M = x_q.shape[0]
    pad = -M % 16
    xp = torch.cat([x_q, x_q.new_zeros((pad, x_q.shape[1]))]) if pad \
        else x_q
    wc = w_q.t().contiguous().t()
    one = torch.ones((), device=x_q.device)
    note = f"torch._scaled_mm, M padded {M}->{M + pad}, B column-major"
    try:
        # (clones keep B column-major)
        ms = cold_ms(lambda a, b: torch._scaled_mm(
            a, b, scale_a=one, scale_b=one, out_dtype=out_dtype),
            (xp, wc), iters)[0]
    except (RuntimeError, TypeError) as e:
        return None, f"torch._scaled_mm raised: {str(e).splitlines()[0]}"
    return ms, note


# ---------------------------------------------------------------------------
# Kernel B: flash attention against its plain version
# ---------------------------------------------------------------------------

FLASH_SHAPES = ((1, 32, 8, 128, 128), (1, 32, 8, 77, 128))  # B, h, kvh, S, hd
# kernel-vs-plain tolerance (absolute, on bf16 outputs of magnitude <= ~3):
# f32 online softmax against a full softmax, then one bf16 rounding.
FLASH_TOL = 2e-2


def flash_flops(B, h, S, hd):
    """Multiply-adds of QK^T and PV over the causal lower triangle."""
    return 4.0 * hd * B * h * S * (S + 1) / 2


def flash_plan_note(B, h, S) -> str:
    """Kernel B's grid at this shape, or a note where the checkout under
    test does not describe it."""
    from repro_torch.kernels import flash_attention as fa
    if not hasattr(fa, "describe_grid"):
        return "no grid description in this checkout"
    return fa.describe_grid(B, h, S)


def flash_phase():
    """Kernel B at the prefill shapes: checked against its plain version
    and for a bit-equal repeat, then timed beside SDPA by device time with
    the operands out of L2 (CUDA-event means as a second column)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def kernel(q, k, v):
        return fa.flash_attention(q, k, v, causal=True)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    rows = []
    for B, h, kvh, S, hd in FLASH_SHAPES:
        q = torch.randn((B, h, S, hd), generator=gen, device="cuda").to(
            torch.bfloat16)
        k = torch.randn((B, kvh, S, hd), generator=gen, device="cuda").to(
            torch.bfloat16)
        v = torch.randn((B, kvh, S, hd), generator=gen, device="cuda").to(
            torch.bfloat16)
        got = kernel(q, k, v)
        again = kernel(q, k, v)
        want = fa.flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        same = bit_equal(got, again)
        ok = bool(torch.isfinite(got).all()) and err <= FLASH_TOL and same
        plan = flash_plan_note(B, h, S)
        print(f"[flash] B={B} h={h} kvh={kvh} S={S} hd={hd} causal: "
              f"max_abs_err={err:.3e} repeat bit-equal={same} plan {plan} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"flash attention S={S} disagrees with its plain version "
                 f"(max_abs_err {err:.3e} > {FLASH_TOL}) or with itself "
                 f"(bit-equal {same})")
        ms, copies = cold_ms(kernel, (q, k, v), 100)
        lib = cold_ms(sdpa, (q, k, v), 100)[0]
        plain = time_ms(
            lambda: fa.flash_attention_plain(q, k, v, causal=True), 20)
        n_bytes = 2 * (2 * B * h * S * hd + 2 * B * kvh * S * hd)
        bms, by = bound_ms(n_bytes, flash_flops(B, h, S, hd), "bf16")
        row = {"label": f"prefill_S{S}", "B": B, "h": h, "kvh": kvh, "S": S,
               "hd": hd, "max_abs_err": err, "ms": ms,
               "event_ms": time_ms(lambda: kernel(q, k, v), 100),
               "plain_ms": plain, "library_ms": lib,
               "library_event_ms": time_ms(lambda: sdpa(q, k, v), 100),
               "library_note": "scaled_dot_product_attention(is_causal=True, "
                               "enable_gqa=True)",
               "bound_ms": bms, "bound_by": by, "plan": plan,
               "operand_copies": copies}
        rows.append(row)
        print(f"[flash-time] {json.dumps(row)}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# Kernel D: the packed 2:4 GEMM against its plain version
# ---------------------------------------------------------------------------

# (label, M, K, N): llama3-8b's four projection shapes (q/o, k/v, gate/up,
# down) at decode (M = slots) and at prefill of both prompt lengths (M = 128
# and the ragged 77), and a shape ragged in N and K.
SPARSE24_SHAPES = (
    ("decode_qo", 4, 4096, 4096),
    ("decode_kv", 4, 4096, 1024),
    ("decode_gate_up", 4, 4096, 14336),
    ("decode_down", 4, 14336, 4096),
    ("prefill_qo", 128, 4096, 4096),
    ("prefill_kv", 128, 4096, 1024),
    ("prefill_gate_up", 128, 4096, 14336),
    ("prefill_down", 128, 14336, 4096),
    ("prefill77_qo", 77, 4096, 4096),
    ("prefill77_kv", 77, 4096, 1024),
    ("prefill_ragged", 77, 4096, 14336),
    ("prefill77_down", 77, 14336, 4096),
    ("ragged_nk", 77, 4000, 1000),
)
SPARSE24_TYPES = ("bf16", "e4m3")


def packed_inputs(M, K, N, kind, gen):
    """x (M, K) bf16 and a weight pruned and packed 2:4 in ``kind``."""
    import torch
    from repro_torch.core import execution as ex
    from repro_torch.core import fp8 as fp8lib
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
    w = w.to(torch.bfloat16) if kind == "bf16" \
        else fp8lib.quantize_weight_static(w, fp8lib.E4M3)[0]
    return x, ex.pack_weight(w)


def semi_structured_ms(w_dense, x, iters):
    """PyTorch's own 2:4 product, (Wᵀ_sparse @ xᵀ)ᵀ, with M padded to a
    multiple of 8; the conversion and the padding are outside the timed
    region. Returns (ms, note, max |err| against ``x @ w_dense`` in f32),
    or (None, the reason, None) where PyTorch refuses the shape."""
    import torch
    M = x.shape[0]
    pad = -M % 8
    xt = torch.cat([x, x.new_zeros((pad, x.shape[1]))]).t().contiguous()
    try:
        from torch.sparse import to_sparse_semi_structured
        ws = to_sparse_semi_structured(w_dense.t().contiguous())
        got = torch.mm(ws, xt).t()[:M]
        torch.cuda.synchronize()
    except Exception as e:                                # noqa: BLE001
        return None, f"to_sparse_semi_structured: {type(e).__name__}: " \
            f"{str(e).splitlines()[0][:160]}", None
    err = (got.float() - torch.matmul(x.float(), w_dense.float())
           ).abs().max().item()
    ms = time_ms(lambda: torch.mm(ws, xt), iters)
    return ms, f"to_sparse_semi_structured, M padded {M}->{M + pad}", err


def sparse24_phase():
    import torch
    from repro_torch.core import sparsity as sp
    from repro_torch.kernels import registry
    from repro_torch.kernels import sparse24_matmul as sm
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    for label, M, K, N in SPARSE24_SHAPES:
        plan = plan_note(M, N, K, "sparse24")
        print(f"[sparse24] {label} M={M} K={K} N={N}: plan {plan}",
              flush=True)
        for kind in SPARSE24_TYPES:
            x, pw = packed_inputs(M, K, N, kind, gen)
            for out_dtype in (torch.float32, torch.bfloat16):
                got = sm.sparse24_matmul(x, pw.values, pw.meta, out_dtype)
                again = sm.sparse24_matmul(x, pw.values, pw.meta, out_dtype)
                want = sm.sparse24_matmul_plain(x, pw.values, pw.meta,
                                                out_dtype)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                name = str(out_dtype).split(".")[-1]
                rel = err / max(scale, 1e-30)
                same = bit_equal(got, again)
                ok = bool(torch.isfinite(got).all()) and \
                    rel <= GEMM_REL_TOL[name] and same
                print(f"[sparse24] {label} M={M} K={K} N={N} {kind}->{name}: "
                      f"max_abs_err={err:.3e} rel={rel:.2e} repeat "
                      f"bit-equal={same} {'ok' if ok else 'MISMATCH'}",
                      flush=True)
                if not ok:
                    fail(f"packed 2:4 GEMM {label} {kind}->{name} disagrees "
                         f"with its plain version (rel {rel:.2e}) or with "
                         f"itself (bit-equal {same})")
            # times at the main path's output type (the activation, bf16)
            out_dtype = torch.bfloat16
            err = (sm.sparse24_matmul(x, pw.values, pw.meta, out_dtype).float()
                   - sm.sparse24_matmul_plain(x, pw.values, pw.meta,
                                              out_dtype).float()
                   ).abs().max().item()
            iters = 50
            ms, copies = cold_ms(
                lambda a, v, m: sm.sparse24_matmul(a, v, m, out_dtype),
                (x, pw.values, pw.meta), iters)
            plain = time_ms(lambda: sm.sparse24_matmul_plain(
                x, pw.values, pw.meta, out_dtype), 5)
            w_dense = sp.unpack_24(pw.values, pw.meta).to(torch.bfloat16)
            lib = cold_ms(torch.matmul, (x, w_dense), iters)[0]
            slib, snote, serr = semi_structured_ms(w_dense, x, iters)
            vbytes = pw.values.element_size()
            n_bytes = M * K * 2 + (K // 2) * N * vbytes + (K // 8) * N \
                + M * N * 2
            # the multiplies this data needs: the kept half of the weight
            bms, by = bound_ms(n_bytes, 2.0 * M * N * (K // 2), "bf16")
            row = {"label": label, "M": M, "K": K, "N": N, "values": kind,
                   "out": "bfloat16", "max_abs_err": err, "ms": ms,
                   "plain_ms": plain, "library_ms": lib,
                   "library_note": "torch.matmul on the unpacked bf16 weight",
                   "sparse_library_ms": slib, "sparse_library_note": snote,
                   "sparse_library_max_abs_err": serr,
                   "bound_ms": bms, "bound_by": by, "plan": plan,
                   "operand_copies": copies}
            if M <= 16:
                row["host_us_per_call"] = host_us(
                    lambda: sm.sparse24_matmul(x, pw.values, pw.meta,
                                               out_dtype))
            rows.append(row)
            print(f"[sparse24-time] {json.dumps(row)}", flush=True)
            if label == "decode_gate_up" and kind == "bf16":
                check_sparse24_primary(x, w_dense, pw, registry)
            del x, pw, w_dense
    return rows


def check_sparse24_primary(x, w_dense, pw, registry):
    """``hopper_sparse24.dense`` prunes and packs per call: on the pruned
    dense weight it must give the packed path's exact result."""
    import torch
    got = registry.get_backend("hopper_sparse24").dense(x, w_dense)
    want = registry.get_backend("hopper").sparse24(x, pw.values, pw.meta)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    print(f"[sparse24] hopper_sparse24.dense on the unpacked weight equals "
          f"the packed path: {same}", flush=True)
    if not same:
        fail("hopper_sparse24.dense differs from hopper.sparse24 on the same "
             "weight")


# ---------------------------------------------------------------------------
# Kernel E: the block-2:4 GEMM against its plain version
# ---------------------------------------------------------------------------

BLOCK24_SHAPES = tuple((M, 4096, 14336, block) for block in (128, 64)
                       for M in (4, 128, 77))


def block24_inputs(M, K, N, block, gen):
    import torch
    from repro_torch.core import sparsity as sp
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device="cuda")
         * K ** -0.5).to(torch.bfloat16)
    wp, keep = sp.prune_block24(w, block)
    kept = tuple(int(i) for i in torch.nonzero(keep).flatten())
    packed = torch.cat([wp[i * block:(i + 1) * block] for i in kept])
    return x, packed.contiguous(), kept


def block24_phase():
    """Kernel E at its phase's shapes. Its only entry point,
    ``ops.block24_matmul``, is driven once per shape with the counter set
    to 0 just before and read just after; the comparisons and timings
    come after that read."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import sparse24_matmul as sm
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    inputs = [block24_inputs(M, K, N, block, gen)
              for M, K, N, block in BLOCK24_SHAPES]
    sm.BLOCK24_LAUNCHES = 0
    for (M, K, N, block), (x, packed, kept) in zip(BLOCK24_SHAPES, inputs):
        out = ops.block24_matmul(x[None], packed, kept, block=block)
        if out.shape != (1, M, N):
            fail(f"ops.block24_matmul gave {tuple(out.shape)}")
    torch.cuda.synchronize()
    entry_launches = sm.BLOCK24_LAUNCHES
    print(f"[block24] ops.block24_matmul over {len(BLOCK24_SHAPES)} shapes: "
          f"{entry_launches} kernel launches", flush=True)
    if entry_launches != len(BLOCK24_SHAPES):
        fail("ops.block24_matmul did not launch kernel E once per call")
    rows = []
    for (M, K, N, block), (x, packed, kept) in zip(BLOCK24_SHAPES, inputs):
        plan = plan_note(M, N, K // 2, "block24")
        for out_dtype in (torch.float32, torch.bfloat16):
            got = sm.block24_matmul(x, packed, kept, block, out_dtype)
            again = sm.block24_matmul(x, packed, kept, block, out_dtype)
            want = sm.block24_matmul_plain(x, packed, kept, block, out_dtype)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            name = str(out_dtype).split(".")[-1]
            rel = err / max(scale, 1e-30)
            same = bit_equal(got, again)
            ok = bool(torch.isfinite(got).all()) and \
                rel <= GEMM_REL_TOL[name] and same
            print(f"[block24] M={M} K={K} N={N} block={block} bf16->{name}: "
                  f"max_abs_err={err:.3e} rel={rel:.2e} repeat bit-equal="
                  f"{same} plan {plan} {'ok' if ok else 'MISMATCH'}",
                  flush=True)
            if not ok:
                fail(f"block-2:4 GEMM M={M} block={block} ->{name} disagrees "
                     f"with its plain version (rel {rel:.2e}) or with itself "
                     f"(bit-equal {same})")
        out_dtype = torch.bfloat16
        err = (sm.block24_matmul(x, packed, kept, block, out_dtype).float()
               - sm.block24_matmul_plain(x, packed, kept, block,
                                         out_dtype).float()
               ).abs().max().item()
        ms, copies = cold_ms(
            lambda a, b: sm.block24_matmul(a, b, kept, block, out_dtype),
            (x, packed), 50)
        plain = time_ms(lambda: sm.block24_matmul_plain(
            x, packed, kept, block, out_dtype), 5)
        cols = torch.cat([torch.arange(i * block, (i + 1) * block,
                                       device="cuda") for i in kept])
        xk = x[:, cols].contiguous()
        lib = cold_ms(torch.matmul, (xk, packed), 50)[0]
        n_bytes = M * (K // 2) * 2 + (K // 2) * N * 2 + M * N * 2
        bms, by = bound_ms(n_bytes, 2.0 * M * N * (K // 2), "bf16")
        row = {"label": f"M{M}_block{block}", "M": M, "K": K, "N": N,
               "block": block, "out": "bfloat16", "max_abs_err": err,
               "ms": ms, "plain_ms": plain, "library_ms": lib,
               "library_note": "torch.matmul on x's kept columns gathered "
                               "beforehand (the gather is left out: no one "
                               "call computes E's function)",
               "bound_ms": bms, "bound_by": by, "plan": plan,
               "operand_copies": copies,
               "entry_point_launches": entry_launches}
        rows.append(row)
        print(f"[block24-time] {json.dumps(row)}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# Kernel C: paged flash decode against its plain version
# ---------------------------------------------------------------------------

# kernel-vs-plain tolerance (absolute, on f32 outputs of magnitude <= ~3):
# f32 pools, JAX's own test tolerance; bf16 pools, both sides sum the same
# bf16 values in f32, in another order.
PAGED_TOL = {"float32": 2e-5, "bfloat16": 1e-4}
# llama3-8b's decode attention: 32 heads over 8 kv heads of 128, pages of
# 16 rows, max_len 512 (32 pages per slot)
PAGED_GEOMETRY = dict(h=32, kvh=8, hd=128)


def serving_tables():
    """Tables of 4 slots from a PageAllocator driven through alloc, extend
    and free, so page ids are out of order: lengths 129, 78, 1 and an idle
    slot with no pages."""
    import torch
    from repro_torch.core.paging import PageAllocator
    a = PageAllocator(128, 16, MAX_LEN // 16, SLOTS)
    a.alloc_slot(0, 40)
    a.alloc_slot(1, 100)
    a.alloc_slot(2, 20)
    a.free_slot(1)
    a.alloc_slot(3, 50)
    a.extend_slot(0, 129)
    a.alloc_slot(1, 78)
    a.free_slot(2)
    a.alloc_slot(2, 1)
    a.free_slot(3)
    pm = torch.as_tensor(a.page_map(), device="cuda")
    return pm, torch.tensor([129, 78, 1, 0], dtype=torch.int32,
                            device="cuda")


def paged_cases(gen):
    """(label, q, k_pages, v_pages, page_map, lengths) at the serving shape,
    at the sweep's shapes (full tables, length 512, pages of 8/16/32) and
    at the JAX test's geometry in f32."""
    import torch

    def pools(B, h, kvh, hd, n_pages, ps, dtype):
        q = torch.randn((B, h, hd), generator=gen, device="cuda").to(dtype)
        kp = torch.randn((n_pages, ps, kvh, hd), generator=gen,
                         device="cuda").to(dtype)
        vp = torch.randn((n_pages, ps, kvh, hd), generator=gen,
                         device="cuda").to(dtype)
        return q, kp, vp

    h, kvh, hd = (PAGED_GEOMETRY[k] for k in ("h", "kvh", "hd"))
    pm, ln = serving_tables()
    cases = [("serving_ps16", *pools(SLOTS, h, kvh, hd, 129, 16,
                                     torch.bfloat16), pm, ln)]
    for ps in (8, 16, 32):
        mp = MAX_LEN // ps
        pm = torch.arange(SLOTS * mp, dtype=torch.int32,
                          device="cuda").reshape(SLOTS, mp)
        ln = torch.full((SLOTS,), MAX_LEN, dtype=torch.int32, device="cuda")
        cases.append((f"sweep_ps{ps}", *pools(SLOTS, h, kvh, hd,
                                              SLOTS * mp + 1, ps,
                                              torch.bfloat16), pm, ln))
    pm = torch.full((3, 4), -1, dtype=torch.int32)
    pm[0, :2] = torch.tensor([5, 9])
    pm[1, :4] = torch.tensor([0, 1, 2, 3])
    pm[2, :1] = 7
    cases.append(("jax_test_f32", *pools(3, 4, 2, 16, 13, 8, torch.float32),
                  pm.cuda(), torch.tensor([13, 32, 1], dtype=torch.int32,
                                          device="cuda")))
    return cases


def paged_work(q, k_pages, page_map, lengths):
    """(bytes, operations, valid rows) of the function on these inputs:
    each valid K and V row read once, q, the f32 output, the table and
    lengths; two multiply-adds per valid row, query head and head-dim
    element."""
    B, h, hd = q.shape
    ps, kvh = k_pages.shape[1], k_pages.shape[2]
    pm = page_map.tolist()
    rows = sum(1 for b, n in enumerate(lengths.tolist())
               for t in range(min(n, len(pm[b]) * ps)) if pm[b][t // ps] >= 0)
    esize = k_pages.element_size()
    n_bytes = 2 * rows * kvh * hd * esize + q.numel() * esize \
        + B * h * hd * 4 + page_map.numel() * 4 + lengths.numel() * 4
    return n_bytes, 4.0 * rows * (h // kvh) * hd, rows


def sdpa_operands(q, k_pages, v_pages, page_map, lengths):
    """``scaled_dot_product_attention``'s operands for the same function:
    each slot's pages gathered and a boolean mask, both made here, outside
    any timed region (rows with nothing valid come out NaN there; only the
    time is kept)."""
    import torch
    B, h, hd = q.shape
    _, ps, kvh, _ = k_pages.shape
    mp = page_map.shape[1]
    safe = page_map.clamp(min=0).long()
    k = k_pages[safe].reshape(B, mp * ps, kvh, hd).transpose(1, 2) \
        .contiguous()
    v = v_pages[safe].reshape(B, mp * ps, kvh, hd).transpose(1, 2) \
        .contiguous()
    pos = torch.arange(mp * ps, device="cuda")
    mask = (pos[None, :] < lengths[:, None]) \
        & (page_map >= 0).repeat_interleave(ps, dim=1)
    return q[:, :, None, :].contiguous(), k, v, mask[:, None, None, :]


def sdpa_masked(q4, k, v, mask):
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                          enable_gqa=True)


def paged_plan_note(q, k_pages, page_map) -> str:
    """Kernel C's split plan at this shape, or a note where the checkout
    under test has none."""
    from repro_torch.kernels import paged_attention as pa
    B, h, hd = q.shape
    _, ps, kvh, _ = k_pages.shape
    if not hasattr(pa, "launch_plan"):
        return f"no split plan in this checkout: grid {kvh}x{B}"
    return pa.launch_plan(B, h, kvh, hd, page_map.shape[1] * ps,
                          q.device)[0].describe(B, kvh)


def paged_phase():
    """Kernel C through its entry point ``paged_decode_attention`` once
    per case, with the counter set to 0 just before and read just after;
    then each case held against the plain version and timed."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cases = paged_cases(gen)
    pa.LAUNCHES = 0
    for label, *args in cases:
        out = pa.paged_decode_attention(*args)
        if out.shape != args[0].shape or out.dtype != torch.float32:
            fail(f"paged_decode_attention {label} gave {tuple(out.shape)} "
                 f"{out.dtype}")
    torch.cuda.synchronize()
    entry_launches = pa.LAUNCHES
    print(f"[paged] paged_decode_attention over {len(cases)} cases: "
          f"{entry_launches} kernel launches", flush=True)
    if entry_launches != len(cases):
        fail("paged_decode_attention did not launch kernel C once per call")
    rows = []
    for label, q, kp, vp, pm, ln in cases:
        got = pa.paged_flash_decode(q, kp, vp, pm, ln)
        again = pa.paged_flash_decode(q, kp, vp, pm, ln)
        want = pa.paged_flash_decode_plain(q, kp, vp, pm, ln)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = PAGED_TOL[str(kp.dtype).split(".")[-1]]
        empty = ln == 0
        same = bit_equal(got, again)
        ok = bool(torch.isfinite(got).all()) and err <= tol \
            and bool((got[empty] == 0).all()) and same
        B, h, hd = q.shape
        _, ps, kvh, _ = kp.shape
        plan = paged_plan_note(q, kp, pm)
        print(f"[paged] {label} B={B} h={h} kvh={kvh} hd={hd} ps={ps} "
              f"mp={pm.shape[1]} {str(kp.dtype).split('.')[-1]} lengths "
              f"{ln.tolist()}: max_abs_err={err:.3e} (tolerance {tol}) "
              f"repeat bit-equal={same} plan {plan} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"paged decode {label} disagrees with its plain version "
                 f"(max_abs_err {err:.3e} > {tol}, or an empty row not 0) "
                 f"or with itself (bit-equal {same})")
        ms, copies = cold_ms(pa.paged_flash_decode, (q, kp, vp, pm, ln), 100)
        sdpa_args = sdpa_operands(q, kp, vp, pm, ln)
        lib = cold_ms(sdpa_masked, sdpa_args, 100)[0]
        plain = time_ms(lambda: pa.paged_flash_decode_plain(
            q, kp, vp, pm, ln), 20)
        n_bytes, n_ops, n_rows = paged_work(q, kp, pm, ln)
        kind = "bf16" if kp.dtype == torch.bfloat16 else "f32"
        bms, by = bound_ms(n_bytes, n_ops, kind)
        row = {"label": label, "B": B, "h": h, "kvh": kvh, "hd": hd,
               "page_size": ps, "max_pages": pm.shape[1],
               "lengths": ln.tolist(), "valid_rows": n_rows,
               "type": kind, "max_abs_err": err, "ms": ms,
               "event_ms": time_ms(
                   lambda: pa.paged_flash_decode(q, kp, vp, pm, ln), 200),
               "plain_ms": plain, "library_ms": lib,
               "library_event_ms": time_ms(lambda: sdpa_masked(*sdpa_args),
                                           200),
               "library_note": "scaled_dot_product_attention after a gather "
                               "and a boolean mask (both untimed)",
               "bytes": n_bytes, "bound_ms": bms, "bound_by": by,
               "plan": plan, "operand_copies": copies,
               "entry_point_launches": entry_launches}
        rows.append(row)
        print(f"[paged-time] {json.dumps(row)}", flush=True)
    return rows


def sweep_phase():
    """fig20's page-geometry sweep at llama3-8b's geometry (4 slots,
    max_len 512): three records, and the best page size recorded in the
    block-shape cache. Returns (records, kernel launches)."""
    import torch
    from repro_torch.core import execution as ex
    from repro_torch.kernels import paged_attention as pa
    h, kvh, hd = (PAGED_GEOMETRY[k] for k in ("h", "kvh", "hd"))
    pa.LAUNCHES = 0
    recs = pa.sweep_paged_tilings(batch=SLOTS, seq=MAX_LEN, head_dim=hd,
                                  kv_heads=kvh, heads=h)
    torch.cuda.synchronize()
    launches = pa.LAUNCHES
    for rec in recs:
        print(f"[sweep] {rec.name}: {rec.us_per_call:.2f} us per call "
              f"(host clock, synchronised; {rec.derived})", flush=True)
    if len(recs) != len(pa.SWEEP_PAGE_SIZES) or launches != 4 * len(recs):
        fail(f"sweep_paged_tilings gave {len(recs)} records and {launches} "
             "kernel launches")
    best = min(recs, key=lambda r: r.us_per_call)
    got = ex.BLOCK_CACHE.lookup(SLOTS, hd, MAX_LEN, "bf16")
    want = (1, best.derived["page_size"], hd)
    print(f"[sweep] BLOCK_CACHE[{SLOTS}, {hd}, {MAX_LEN}, bf16] = {got} "
          f"(best page size {want[1]})", flush=True)
    if got != want:
        fail(f"BLOCK_CACHE holds {got} for the sweep's shape, not {want}")
    return recs, launches


# ---------------------------------------------------------------------------
# Split scratch per stream: two split launches in flight on two streams
# ---------------------------------------------------------------------------

STREAM_ROUNDS = 8


def streams_phase():
    """Kernel A at the decode gate/up shape, D at its own, and C at the
    serving shape, each with a plan that splits (so its launches share a
    workspace and counters on one stream): two input sets, each called
    alone, then both called on two streams at once, STREAM_ROUNDS times.
    Every output must be bit-equal to the call made alone."""
    import torch
    from repro_torch.core import sparsity as sp
    from repro_torch.kernels import fp8_matmul as fm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sparse24_matmul as sm
    h, kvh, hd = (PAGED_GEOMETRY[k] for k in ("h", "kvh", "hd"))

    def call(kernel, seed):
        gen = torch.Generator(device="cuda").manual_seed(SEED + seed)
        if kernel == "C":
            q, kp, vp = (torch.randn(shape, generator=gen, device="cuda")
                         .bfloat16() for shape in
                         ((SLOTS, h, hd), (129, 16, kvh, hd),
                          (129, 16, kvh, hd)))
            pm, ln = serving_tables()
            plan = paged_plan_note(q, kp, pm)
            return (lambda: pa.paged_flash_decode(q, kp, vp, pm, ln)), plan
        x = torch.randn((SLOTS, 4096), generator=gen,
                        device="cuda").bfloat16()
        w = (torch.randn((4096, 14336), generator=gen, device="cuda")
             * 4096 ** -0.5).bfloat16()
        if kernel == "A":
            return (lambda: fm.fp8_matmul(x, w, torch.bfloat16),
                    plan_note(SLOTS, 14336, 4096, "gemm"))
        values, meta = sp.pack_24(sp.prune_24(w))
        return (lambda: sm.sparse24_matmul(x, values, meta, torch.bfloat16),
                plan_note(SLOTS, 14336, 4096, "sparse24"))

    rows = []
    for kernel in ("A", "D", "C"):
        (one, plan), (two, _) = call(kernel, 11), call(kernel, 12)
        alone = [one(), two()]
        torch.cuda.synchronize()
        streams = [torch.cuda.Stream(), torch.cuda.Stream()]
        for st in streams:
            st.wait_stream(torch.cuda.current_stream())
        outs = [[], []]
        t0 = time.perf_counter()
        for _ in range(STREAM_ROUNDS):
            for i, (st, fn) in enumerate(zip(streams, (one, two))):
                with torch.cuda.stream(st):
                    outs[i].append(fn())
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        same = all(bit_equal(o, want) for want, got in zip(alone, outs)
                   for o in got)
        print(f"[streams] kernel {kernel} ({plan}): {STREAM_ROUNDS} rounds "
              f"of two launches on two streams, every output bit-equal to "
              f"its call alone: {same} ({wall_ms:.2f} ms wall)", flush=True)
        if not same:
            fail(f"kernel {kernel} on two streams differs from its call "
                 "alone: the split scratch is shared across streams")
        rows.append({"kernel": kernel, "plan": plan, "bit_equal": same})
    return rows


# ---------------------------------------------------------------------------
# Set-up
# ---------------------------------------------------------------------------

def preflight(src: Path = SRC) -> str:
    """Refuse to run without the port's sources or a CUDA device."""
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"[smoke] the port's sources are not under {src}: run this "
              "script from a checkout of the repository", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("[smoke] no CUDA device: this script measures the port on "
              "the card and has nothing to run here", file=sys.stderr)
        sys.exit(3)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    print(f"[smoke] nvidia-smi: {smi}", flush=True)
    return smi


def build_phase():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build()
    total = time.perf_counter() - t0
    per = ", ".join(f"{n} {s:.1f}s" for n, s in _build.SECONDS.items())
    print(f"[build] nvcc sm_90a: {per}; wall {total:.1f}s", flush=True)
    for name, log in _build.LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)


# ---------------------------------------------------------------------------
# The main path: ServeSession on llama3-8b at its published width
# ---------------------------------------------------------------------------

# The port's kernel launch counters, by the name the kernel line gives each
# kernel, and the kernels each sparsity's serving path must launch (the
# others must not launch there).
# (Kernel C is on no serving path, paged or dense: as in the reference, the
# paged decode step gathers pages with plain tensor ops.)
PATH_KERNELS = {"dense": ("gemm", "flash_attention"),
                "sparse24": ("gemm", "flash_attention", "sparse24_gemm")}


def launch_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fp8_matmul as fm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sparse24_matmul as sm
    return {"gemm": fm.LAUNCHES, "flash_attention": fa.LAUNCHES,
            "paged_attention": pa.LAUNCHES, "sparse24_gemm": sm.LAUNCHES,
            "block24_gemm": sm.BLOCK24_LAUNCHES}


def zero_launch_counts() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fp8_matmul as fm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sparse24_matmul as sm
    fm.LAUNCHES = fa.LAUNCHES = pa.LAUNCHES = sm.LAUNCHES = \
        sm.BLOCK24_LAUNCHES = 0
    fm.TYPE_LAUNCHES.update(dict.fromkeys(fm.TYPE_LAUNCHES, 0))


def _margin(row) -> float:
    import torch
    top = torch.topk(row.float(), 2).values
    return float(top[0] - top[1])


def check_completed(tag, run) -> None:
    n_done = len(run["outs"])
    if n_done != N_REQUESTS or any(len(o) != MAX_NEW
                                   for o in run["outs"].values()):
        fail(f"{tag}: {n_done}/{N_REQUESTS} requests completed")


def mean_ms(seconds) -> float:
    return 1e3 * sum(seconds) / len(seconds)


def run_times(tag, run) -> dict:
    """The end-to-end metrics of one ``drive`` run."""
    n_tok = sum(len(o) for o in run["outs"].values())
    dec_ms = sorted(1e3 * t for t in run["decode_s"])
    pre_ms = sorted(1e3 * t for t in run["prefill_s"])
    return {"policy": tag, "requests": len(run["outs"]), "tokens": n_tok,
            "prefill_ms": mean_ms(run["prefill_s"]),
            "prefill_ms_median": pre_ms[len(pre_ms) // 2],
            "prefill_ms_first": 1e3 * run["prefill_s"][0],
            "decode_ms_per_step": sum(dec_ms) / len(dec_ms),
            "decode_ms_median": dec_ms[len(dec_ms) // 2],
            # the highest percentile with ten samples beyond it
            "decode_ms_p67": dec_ms[max(0, len(dec_ms) - 11)],
            "decode_steps": len(dec_ms),
            "tok_s": n_tok / run["wall_s"], "wall_s": run["wall_s"]}


def drive(sess, requests, twin=None, after_first_decode=None):
    """Serve ``requests`` the way ``ServeSession.run`` does, one admission
    and one decode step at a time, timing each (host clock around work
    that ends in a device synchronise) and keeping what the comparison
    needs: the first prefill's and first decode's logits, and the top-2
    margin behind every token. ``twin(params, tokens, caches, pos)`` is
    run on a copy of the state the first decode step starts from, so its
    logits compare with that step's on identical inputs;
    ``after_first_decode(sess)`` is called once, after that step."""
    import numpy as np
    import torch
    for r in requests:
        sess.submit(r)
    first = {}
    margins = {}
    prefill_s, decode_s = [], []
    t_start = time.perf_counter()
    while sess.queue or sess.n_active:
        while sess.queue and sess.can_admit(sess.queue[0]):
            req = sess.queue.pop(0)
            t0 = time.perf_counter()
            sess.admit(req)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
            first.setdefault("prefill", sess.last_logits[0].float().clone())
            margins[(req.uid, 0)] = _margin(sess.last_logits[0])
        active = [(i, r, len(r.out)) for i, r in enumerate(sess.slots)
                  if r is not None]
        state = None
        if twin is not None and "decode" not in first:
            state = (sess.tokens.clone(),
                     [{k: v.clone() for k, v in c.items()}
                      for c in sess.caches],
                     torch.as_tensor(sess.slot_pos.astype(np.int64),
                                     device=sess.device))
        t0 = time.perf_counter()
        sess.decode_once()
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
        if "decode" not in first:
            first["decode"] = sess.last_logits.float().clone()
            first["decode_rows"] = [i for i, _, _ in active]
            if state is not None:
                first["decode_twin"] = twin(sess.params, *state).float()
            if after_first_decode is not None:
                after_first_decode(sess)
        for i, r, n in active:
            margins[(r.uid, n)] = _margin(sess.last_logits[i])
    wall = time.perf_counter() - t_start
    outs = {r.uid: list(r.out) for r in sess.completed}
    return {"outs": outs, "first": first, "margins": margins,
            "prefill_s": prefill_s, "decode_s": decode_s, "wall_s": wall}


def serve_phase():
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import execution as ex
    from repro_torch.models import init_params
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.runtime.serve_loop import (
        Request, ServeSession, make_serve_step)

    cfg = get_arch("llama3-8b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = cfg.param_count()
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers (no depth cut), "
          f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, heads {cfg.num_heads}/"
          f"{cfg.num_kv_heads}, hd {cfg.head_dim}, vocab {cfg.vocab_size}; "
          f"{n_params / 1e9:.2f} B params, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card, "
          f"init {time.perf_counter() - t0:.1f}s", flush=True)

    rng = np.random.default_rng(SEED)
    lens = [PROMPT_LENS[i % len(PROMPT_LENS)] for i in range(N_REQUESTS)]
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in lens]

    def requests():
        return [Request(uid=i, prompt=p, max_new=MAX_NEW)
                for i, p in enumerate(prompts)]

    results = {}
    for precision in ("bf16", "fp8"):
        tag = f"{precision}:dense:hopper"

        def session(backend, use_pallas):
            return ServeSession(
                params, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
                rt=RuntimeCfg(use_pallas=use_pallas),
                policy=ex.parse_policy(f"{precision}:dense:{backend}"),
                device="cuda")

        torch_step = make_serve_step(
            cfg, RuntimeCfg(),
            policy=ex.parse_policy(f"{precision}:dense:torch"))

        def twin(p, tokens, caches, pos):
            return torch_step(p, tokens, caches, pos)[1]

        hop = session("hopper", True)
        zero_launch_counts()
        run = drive(hop, requests(), twin)
        launches = launch_counts()
        del hop
        base = drive(session("torch", False), requests())
        if launch_counts() != launches:
            fail("the torch-backend session launched a port kernel")
        results[tag] = check_serve(tag, run, base, launches)
        results[tag].update(profile_decode(
            session("hopper", True), requests(),
            results[tag]["decode_ms_per_step"]))
        if precision == "bf16":
            results[PAGED_TAG] = serve_paged(params, cfg, requests, run,
                                             launches)
    torch.cuda.empty_cache()
    results["bf16:sparse24:hopper"], packed = serve_sparse24(params, cfg,
                                                             requests)
    torch.cuda.empty_cache()
    results.update(serve_spec(params, cfg))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    concurrency_phase(params, cfg)
    results.update(runtime_phase(params, packed, cfg))
    print(f"[runtime] the [concurrency] and [runtime] phases took "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    del params, packed
    torch.cuda.empty_cache()
    return results


PAGED_TAG = "bf16:dense:hopper paged"
# the paged run's pool: 32 pages of 16 rows, a quarter of the dense cache
PAGE_SIZE, PAGES = 16, 32
# layers whose live pools kernel C reads after the paged run's first step
LIVE_LAYERS = (0, 15, 31)


def serve_paged(params, cfg, requests, dense_run, dense_launches):
    """``bf16:dense:hopper`` from a paged cache: the same params and
    requests as the dense run, whose greedy tokens it must equal exactly
    (the reference's contract: the same kernels on the same data, masked
    rows weighted exactly 0). Kernels A and B launch as often as in the
    dense run, C, D and E never. Then kernel C through
    ``paged_decode_attention`` on the live pools of three layers, as they
    stood after the first decode step, against its plain version."""
    import numpy as np
    import torch
    from repro_torch.core import execution as ex
    from repro_torch.core.paging import pages_for
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.runtime.serve_loop import ServeSession

    peak = 0
    for i in range(0, N_REQUESTS, SLOTS):     # admitted in waves of SLOTS
        peak = max(peak, sum(pages_for(len(r.prompt) + MAX_NEW - 1,
                                       PAGE_SIZE)
                             for r in requests()[i:i + SLOTS]))
    print(f"[serve] {PAGED_TAG}: at most {peak} of {PAGES} pages in use "
          f"(a slot writes prompt + {MAX_NEW - 1} positions)", flush=True)

    def session(paged=True):
        kw = dict(paged=True, page_size=PAGE_SIZE, pages=PAGES) if paged \
            else {}
        return ServeSession(
            params, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
            rt=RuntimeCfg(use_pallas=True),
            policy=ex.parse_policy("bf16:dense:hopper"), device="cuda", **kw)

    live = {}

    def keep_live(sess):
        lengths = [int(p) if r is not None else 0
                   for p, r in zip(sess.slot_pos, sess.slots)]
        live.update(
            page_map=sess._page_map.clone(),
            lengths=torch.tensor(lengths, dtype=torch.int32, device="cuda"),
            pools={i: (sess.caches[i]["k"].clone(),
                       sess.caches[i]["v"].clone()) for i in LIVE_LAYERS})

    sess = session()
    zero_launch_counts()
    run = drive(sess, requests(), after_first_decode=keep_live)
    launches = launch_counts()
    peak_used = sess.pager.stats()["peak_pages_in_use"]
    pool_bytes = sum(t.numel() * t.element_size()
                     for c in sess.caches for t in c.values())
    # the dense cache: k and v bf16 and pos int32 per layer, slot and row
    dense_bytes = cfg.num_layers * SLOTS * MAX_LEN * (
        2 * cfg.num_kv_heads * cfg.head_dim * 2 + 4)
    del sess
    check_completed(PAGED_TAG, run)
    same = sum(run["outs"][u] == dense_run["outs"][u]
               for u in dense_run["outs"])
    rows = run["first"]["decode_rows"]
    pre = float((run["first"]["prefill"]
                 - dense_run["first"]["prefill"]).abs().max())
    dec = float((run["first"]["decode"][rows]
                 - dense_run["first"]["decode"][rows]).abs().max())
    print(f"[serve] {PAGED_TAG}: greedy tokens equal to the dense "
          f"bf16:dense:hopper run for {same}/{N_REQUESTS} requests; logits "
          f"against the dense run: first prefill max_abs_diff={pre}, first "
          f"decode (active rows {rows}) max_abs_diff={dec}", flush=True)
    if same != N_REQUESTS:
        fail(f"{PAGED_TAG}: greedy tokens differ from the dense run")
    want = dict(dense_launches, paged_attention=0, sparse24_gemm=0,
                block24_gemm=0)
    print(f"[serve] {PAGED_TAG}: launches {launches}, expected {want}",
          flush=True)
    if launches != want:
        fail(f"{PAGED_TAG}: kernel launches {launches}, expected {want}")

    # kernel C on the session's own pools
    q_np = np.random.default_rng(SEED + 5).normal(
        size=(SLOTS, cfg.num_heads, cfg.head_dim)).astype(np.float32)
    q = torch.from_numpy(q_np).to("cuda", torch.bfloat16)
    pa.LAUNCHES = 0
    outs = {i: pa.paged_decode_attention(q, kp, vp, live["page_map"],
                                         live["lengths"])
            for i, (kp, vp) in live["pools"].items()}
    torch.cuda.synchronize()
    live_launches = pa.LAUNCHES
    if live_launches != len(LIVE_LAYERS):
        fail("paged_decode_attention did not launch kernel C once per layer")
    live_err = 0.0
    for i, got in outs.items():
        kp, vp = live["pools"][i]
        want_i = pa.paged_flash_decode_plain(q, kp, vp, live["page_map"],
                                             live["lengths"])
        err = (got - want_i).abs().max().item()
        live_err = max(live_err, err)
        ok = bool(torch.isfinite(got).all()) and err <= PAGED_TOL["bfloat16"]
        print(f"[paged] live pools of layer {i} (lengths "
              f"{live['lengths'].tolist()}): max_abs_err={err:.3e} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"kernel C on layer {i}'s live pools disagrees with its "
                 "plain version")
    res = dict(run_times(PAGED_TAG, run),
               dense_decode_ms_per_step=mean_ms(dense_run["decode_s"]),
               launches=launches, first_prefill_diff=pre,
               first_decode_diff=dec, tokens_equal_dense=same,
               page_size=PAGE_SIZE, pages=PAGES, peak_pages_in_use=peak_used,
               kv_bytes_paged=pool_bytes, kv_bytes_dense=dense_bytes,
               live_pool_launches=live_launches,
               live_pool_max_abs_err=live_err)
    # decode time of the two layouts in turns, dense run first: dense,
    # paged (above), paged, dense
    again = {}
    for name, paged in (("paged", True), ("dense", False)):
        again[name] = mean_ms(drive(session(paged), requests())["decode_s"])
    res.update(decode_ms_per_step_again_paged=again["paged"],
               decode_ms_per_step_again_dense=again["dense"])
    print(f"[serve-time] {json.dumps(res)}", flush=True)
    res.update(profile_decode(session(), requests(),
                              res["decode_ms_per_step"]))
    return res


# The speculative run: 4 requests of 16 new tokens from prompts of these
# lengths; the 499-token one is cut at max_len after 13 decode positions,
# mid-commit whenever its last step's accepted prefix runs past the end.
SPEC_PROMPT_LENS = (128, 77, 128, 499)
# (tag, draft policy, k, paged): the session's policy is bf16:dense:hopper
SPEC_ARMS = (("spec bf16-draft k4", "bf16:dense:hopper", 4, False),
             ("spec fp8-draft k4", "fp8:dense:hopper", 4, False),
             ("spec fp8:sparse24-draft k2 paged", "fp8:sparse24:hopper", 2,
              True))
# the paged arm's pool: 56 pages of 16 rows, what the four requests hold at
# their longest in plain decode (9 + 6 + 9 + 32), one page more than they
# take at admission: candidate pages are grown into the pool's last free
# pages, and a step whose candidates do not fit falls back to plain decode
SPEC_PAGES = 56


def drive_spec(sess, requests):
    """Serve ``requests`` one admission and one decode step at a time (host
    clock around work that ends in a device sync), keeping each decode
    step's depth: k of a speculative step (its verify logits are (slots,
    k, Vp)), 1 of a plain one."""
    import torch
    for r in requests:
        sess.submit(r)
    prefill_s, decode_s, depths = [], [], []
    t_start = time.perf_counter()
    while sess.queue or sess.n_active:
        while sess.queue and sess.can_admit(sess.queue[0]):
            t0 = time.perf_counter()
            sess.admit(sess.queue.pop(0))
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        sess.decode_once()
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
        lg = sess.last_logits
        depths.append(lg.shape[1] if lg.dim() == 3 else 1)
    return {"outs": {r.uid: list(r.out) for r in sess.completed},
            "prefill_s": prefill_s, "decode_s": decode_s, "depths": depths,
            "wall_s": time.perf_counter() - t_start}


def spec_launches_expected(cfg, draft, run) -> dict:
    """The launches a speculative run must make, from its prefills and
    each decode step's depth: A 225 per prefill and per verify step (k per
    speculative step, 1 per plain one), B one per layer per prefill, and
    per draft step (k - 1 per speculative step) the draft's: 225 on A in
    bf16, or 224 on A in e4m3 and the head on A in bf16, or 224 packed on
    D and the head on A."""
    per = 7 * cfg.num_layers + 1
    n_pre = len(run["prefill_s"])
    verify = sum(run["depths"])
    drafts = sum(k - 1 for k in run["depths"])
    bf16 = per * (n_pre + verify) + (per if draft.startswith("bf16")
                                     else 1) * drafts
    e4m3 = (per - 1) * drafts if draft == "fp8:dense:hopper" else 0
    packed = (per - 1) * drafts if "sparse24" in draft else 0
    return {"launches": {"gemm": bf16 + e4m3,
                         "flash_attention": cfg.num_layers * n_pre,
                         "paged_attention": 0, "sparse24_gemm": packed,
                         "block24_gemm": 0},
            "gemm_by_type": {"bf16": bf16, "e4m3": e4m3, "e5m2": 0}}


def serve_spec(params, cfg):
    """Speculative serving through ``ServeSession(speculative=...)`` from
    the same weights: first the plain ``bf16:dense:hopper`` run of the
    requests, then each arm of SPEC_ARMS. Each arm's greedy tokens must
    equal the plain run's exactly (the same backend runs both), the
    bf16-draft arm must accept every draft, and the launch counters must
    match ``spec_launches_expected``; its acceptance, tokens per step and
    ms per committed token are printed beside the plain run's."""
    import numpy as np
    import torch
    from repro_torch.core import execution as ex
    from repro_torch.kernels import fp8_matmul as fm
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.runtime.serve_loop import Request, ServeSession

    rng = np.random.default_rng(SEED + 16)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in SPEC_PROMPT_LENS]

    def requests():
        return [Request(uid=i, prompt=p, max_new=MAX_NEW)
                for i, p in enumerate(prompts)]

    def session(spec=None, paged=False):
        kw = dict(paged=True, page_size=PAGE_SIZE, pages=SPEC_PAGES) \
            if paged else {}
        return ServeSession(
            params, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
            rt=RuntimeCfg(use_pallas=True),
            policy=ex.parse_policy("bf16:dense:hopper"), speculative=spec,
            device="cuda", **kw)

    plain = drive_spec(session(), requests())
    if any(len(o) != MAX_NEW for u, o in plain["outs"].items() if u != 3) \
            or len(plain["outs"][3]) != MAX_LEN - SPEC_PROMPT_LENS[3] + 1:
        fail("spec: the plain run did not serve the requests in full")
    plain_tok = sum(len(o) - 1 for o in plain["outs"].values())
    plain_ms_tok = 1e3 * sum(plain["decode_s"]) / plain_tok
    print(f"[spec] plain bf16:dense:hopper: {len(plain['decode_s'])} decode "
          f"steps, {plain_tok} decode tokens, "
          f"{plain_ms_tok:.2f} ms per committed token", flush=True)
    results = {}
    for tag, draft, k, paged in SPEC_ARMS:
        # set-up (a 2:4 draft packs its copy of the weights on the card)
        # ends in a sync, so that no prefill below waits for it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess = session({"k": k, "draft_policy": draft}, paged)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        zero_launch_counts()
        run = drive_spec(sess, requests())
        torch.cuda.synchronize()
        launches = launch_counts()
        by_type = dict(fm.TYPE_LAUNCHES)
        totals = {key: sum(t[key] for t in sess.spec_totals.values())
                  for key in ("steps", "drafted", "accepted", "committed")}
        trims = sess.pager.trim_count if paged else 0
        del sess
        torch.cuda.empty_cache()
        same = sum(run["outs"][u] == plain["outs"][u] for u in plain["outs"])
        want = spec_launches_expected(cfg, draft, run)
        n_tok = sum(len(o) - 1 for o in run["outs"].values())
        steps = len(run["decode_s"])
        res = {"policy": tag, "draft_policy": draft, "k": k, "paged": paged,
               "requests": len(run["outs"]), "tokens_equal_plain": same,
               "decode_steps": steps,
               "speculative_steps": sum(d > 1 for d in run["depths"]),
               "acceptance": totals, "accept_rate":
                   totals["accepted"] / max(1, totals["drafted"]),
               "tokens_per_slot_step": totals["committed"]
                   / max(1, totals["steps"]),
               "tokens_per_step": n_tok / steps,
               "ms_per_committed_token": 1e3 * sum(run["decode_s"]) / n_tok,
               "plain_ms_per_committed_token": plain_ms_tok,
               "decode_ms_per_step": mean_ms(run["decode_s"]),
               "plain_decode_ms_per_step": mean_ms(plain["decode_s"]),
               "prefill_ms": mean_ms(run["prefill_s"]),
               "session_setup_s": setup_s, "page_trims": trims, "launches": launches,
               "gemm_by_type": by_type, "expected": want}
        print(f"[spec] {tag}: greedy tokens equal to the plain run for "
              f"{same}/{len(plain['outs'])} requests; drafted "
              f"{totals['drafted']} accepted {totals['accepted']} committed "
              f"{totals['committed']} ({res['accept_rate']:.3f}); "
              f"{res['tokens_per_slot_step']:.2f} tokens per slot-step; "
              f"{res['ms_per_committed_token']:.2f} ms per committed token "
              f"(plain {plain_ms_tok:.2f}); launches {launches}, A by type "
              f"{by_type}, expected {want}", flush=True)
        print(f"[spec-time] {json.dumps(res)}", flush=True)
        if same != len(plain["outs"]):
            fail(f"{tag}: greedy tokens differ from the plain run")
        if draft == "bf16:dense:hopper" and \
                totals["accepted"] != totals["drafted"]:
            fail(f"{tag}: the draft equals the verify, yet only "
                 f"{totals['accepted']} of {totals['drafted']} drafts were "
                 "accepted")
        if launches != want["launches"] or by_type != want["gemm_by_type"]:
            fail(f"{tag}: kernel launches {launches} (A by type {by_type}), "
                 f"expected {want}")
        results[tag] = res
    return results


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a parameter tree (packed leaves count
    their values and meta)."""
    import torch
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def serve_sparse24(params, cfg, requests):
    """``bf16:sparse24:hopper``: the session prunes and packs the weights
    at construction (timed here) and runs every packed linear on kernel D,
    the LM head on kernel A and prefill attention on kernel B. The torch-
    backend session and twin step take the same packed weights."""
    import torch
    from repro_torch.core import execution as ex
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.runtime.serve_loop import ServeSession, make_serve_step
    tag = "bf16:sparse24:hopper"

    def session(p, backend, use_pallas):
        return ServeSession(
            p, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
            rt=RuntimeCfg(use_pallas=use_pallas),
            policy=ex.parse_policy(f"bf16:sparse24:{backend}"),
            device="cuda")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hop = session(params, "hopper", True)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    packed = hop.params
    dense_gib, packed_gib = tree_bytes(params) / 2**30, \
        tree_bytes(packed) / 2**30
    n_packed = sum(isinstance(w, ex.PackedWeight) for layer in packed["layers"]
                   for group in ("attn", "mlp") for w in layer[group].values())
    print(f"[serve] {tag}: pruned and packed {n_packed} linears in "
          f"{pack_s:.2f}s on the card; weights {packed_gib:.2f} GiB packed "
          f"(embed, head, norms dense) against {dense_gib:.2f} GiB dense",
          flush=True)
    check_pack_on_cpu(params, packed)

    torch_step = make_serve_step(
        cfg, RuntimeCfg(), policy=ex.parse_policy("bf16:sparse24:torch"))

    def twin(p, tokens, caches, pos):
        return torch_step(p, tokens, caches, pos)[1]

    zero_launch_counts()
    run = drive(hop, requests(), twin)
    launches = launch_counts()
    del hop
    base = drive(session(packed, "torch", False), requests())
    if launch_counts() != launches:
        fail("the torch-backend session launched a port kernel")
    res = check_serve(tag, run, base, launches)
    # every packed linear on D, the head alone on A, prefill attention on B
    steps = len(run["prefill_s"]) + len(run["decode_s"])
    per_step = 7 * cfg.num_layers
    want = {"gemm": steps,
            "flash_attention": cfg.num_layers * len(run["prefill_s"]),
            "paged_attention": 0, "sparse24_gemm": per_step * steps,
            "block24_gemm": 0}
    print(f"[serve] {tag}: launches {launches} over {len(run['prefill_s'])} "
          f"prefills + {len(run['decode_s'])} decode steps; expected "
          f"{want} ({per_step} packed GEMMs per step)", flush=True)
    if launches != want:
        fail(f"{tag}: kernel launches {launches}, expected {want}")
    res.update({"pack_s": pack_s, "weights_gib_packed": packed_gib,
                "weights_gib_dense": dense_gib,
                "sparse24_launches_per_step": per_step})
    res.update(profile_decode(session(packed, "hopper", True), requests(),
                              res["decode_ms_per_step"]))
    return res, packed


def check_pack_on_cpu(params, packed):
    """Layer 0's w_gate, pruned and packed on the card by the session, has
    the bytes ``pack_model_params`` gives on the CPU."""
    import torch
    from repro_torch.core import execution as ex
    w = params["layers"][0]["mlp"]["w_gate"]
    t0 = time.perf_counter()
    cpu = ex.pack_model_params({"layers": [{"mlp": {"w_gate": w.cpu()}}]})
    cpu = cpu["layers"][0]["mlp"]["w_gate"]
    card = packed["layers"][0]["mlp"]["w_gate"]
    same = torch.equal(card.meta.cpu(), cpu.meta) and torch.equal(
        card.values.cpu().view(torch.int16), cpu.values.view(torch.int16))
    print(f"[sparse24] pack_model_params of layer 0 w_gate "
          f"{tuple(w.shape)}: card bytes equal CPU bytes: {same} "
          f"(CPU pack {time.perf_counter() - t0:.1f}s)", flush=True)
    if not same:
        fail("the packed weight differs between the card and the CPU")


# ---------------------------------------------------------------------------
# Lanes on CUDA streams: the paper's Fig 4/5, and the multi-tenant runtime
# ---------------------------------------------------------------------------

def device_spans(prof):
    """(start µs, end µs, stream) of every kernel in a torch.profiler
    trace."""
    return [(e.time_range.start, e.time_range.end,
             getattr(e, "device_resource_id", getattr(e, "thread", 0)))
            for e in prof.events()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]


def busy_us(spans) -> float:
    """Union of the kernel intervals: time the card ran anything."""
    busy, end = 0.0, None
    for a, b, _ in sorted(spans):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy


def multi_stream_us(spans) -> float:
    """Time during which kernels of two or more streams ran at once."""
    edges = sorted([(a, 1, st) for a, b, st in spans]
                   + [(b, -1, st) for a, b, st in spans])
    live, total, last = {}, 0.0, None
    for t, d, st in edges:
        if last is not None and sum(1 for n in live.values() if n > 0) >= 2:
            total += t - last
        live[st] = live.get(st, 0) + d
        last = t
    return total


def profiled(fn):
    """Run ``fn`` under torch.profiler (ending in a device synchronise);
    returns its kernel spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_spans(prof)


CONC_STREAMS = (1, 2, 4, 8)
CONC_LAYERS = 16         # (k/v, gate/up) pairs of layers per stream


def concurrency_phase(params, cfg):
    """The paper's Fig 4/5 on the card: ``characterize_streams`` with 1,
    2, 4 and 8 lanes (CUDA streams), serial and async. Every stream runs
    kernel A at two decode shapes, k/v (M=4 K=4096 N=1024) and gate/up
    (M=4 K=4096 N=14336), over CONC_LAYERS layers' own weights. Prints
    each StreamReport and, from a profile of one async round at 8 streams,
    the share of kernel time during which two or more streams ran at
    once. No gate on the numbers."""
    import torch
    from repro_torch.core import concurrency as cc
    from repro_torch.kernels import registry
    hop = registry.get_backend("hopper")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.randn((SLOTS, cfg.d_model), generator=gen,
                    device="cuda").bfloat16()
    layers = params["layers"]

    def make(i):
        ws = [(layers[(CONC_LAYERS * i + j) % len(layers)]["attn"]["w_k"],
               layers[(CONC_LAYERS * i + j) % len(layers)]["mlp"]["w_gate"])
              for j in range(CONC_LAYERS)]

        def thunk():
            out = None
            for wk, wg in ws:
                hop.dense(x, wk, out_dtype=torch.bfloat16)
                out = hop.dense(x, wg, out_dtype=torch.bfloat16)
            return out
        return thunk

    rows = []
    for n in CONC_STREAMS:
        for mode in ("serial", "async"):
            rep = cc.characterize_streams(make, n, mode=mode, warmup=2)
            row = {"n_streams": n, "mode": mode,
                   "wall_ms": 1e3 * rep.wall_s,
                   "serial_wall_ms": 1e3 * rep.serial_wall_s,
                   "speedup": rep.speedup,
                   "overlap_efficiency": rep.overlap_efficiency,
                   "fairness": rep.fairness,
                   "fairness_min_max": rep.fairness_min_max, "cv": rep.cv,
                   "per_stream_ms": [1e3 * t for t in rep.per_stream_s]}
            print(f"[concurrency] {json.dumps(row)}", flush=True)
            rows.append(row)
    n = CONC_STREAMS[-1]
    lanes = [cc.ExecutionLane(f"stream{i}", index=i) for i in range(n)]
    thunks = [make(i) for i in range(n)]
    cc.run_async_dispatch(thunks, lanes)
    torch.cuda.synchronize()
    spans = profiled(lambda: cc.run_async_dispatch(thunks, lanes))
    busy = busy_us(spans)
    multi = multi_stream_us(spans)
    kernel_time = sum(b - a for a, b, _ in spans)
    span = max(b for _, b, _ in spans) - min(a for a, _, _ in spans)
    print(f"[concurrency] one async round of {n} streams under "
          f"torch.profiler: {len(spans)} kernels on "
          f"{len({st for _, _, st in spans})} streams; kernel time "
          f"{kernel_time / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms of "
          f"the {span / 1e3:.3f} ms from the first kernel's start to the "
          f"last one's end, two or more streams at once "
          f"{multi / 1e3:.3f} ms = {multi / max(busy, 1e-9):.3f} of the "
          "busy time", flush=True)
    return rows


RUNTIME_TENANTS = (("chat", "latency:12"), ("api", None),
                   ("batch", "batch:0.9"))
RUNTIME_REQUESTS = 12
RUNTIME_POLICIES = ("bf16:dense:hopper", "bf16:sparse24:hopper")
MIGRATE_AFTER = 3            # rounds before run C's migrate


def runtime_requests(cfg):
    """(tenant, Request) for RUNTIME_REQUESTS requests, four per tenant,
    prompts of 128 and 77 random tokens in turn (numpy seed SEED)."""
    import numpy as np
    from repro_torch.runtime.serve_loop import Request
    rng = np.random.default_rng(SEED)
    out = []
    for i in range(RUNTIME_REQUESTS):
        n = PROMPT_LENS[i % len(PROMPT_LENS)]
        prompt = rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
        out.append((RUNTIME_TENANTS[i % len(RUNTIME_TENANTS)][0],
                    Request(uid=i, prompt=prompt, max_new=MAX_NEW)))
    return out


def runtime_spec(policies, overlap, pins=None, tenants=True):
    """The runtime phase's spec: ``pins`` pins every tenant to that
    partition (else ``spread`` places them); without ``tenants`` none is
    declared (a replay registers the trace's own)."""
    from repro_torch.runtime.server import (
        PartitionSpec, ServingSpec, TenantSpec)
    return ServingSpec(
        partitions=tuple(PartitionSpec(policy=p, admission="fair_quantum")
                         for p in policies),
        placement="spread", batch_slots=SLOTS, max_len=MAX_LEN,
        overlap=overlap, metrics=True,
        tenants=tuple(TenantSpec(id=t, slo=slo, partition=pins)
                      for t, slo in RUNTIME_TENANTS) if tenants else ())


def drive_runtime(runtime, cfg, migrate=None):
    """Submit the runtime requests and drain, one timed lockstep round at
    a time (each ends in a device synchronise); ``migrate=(tenant, dst)``
    migrates after MIGRATE_AFTER rounds. Returns the run's record: tokens
    per request, wall, rounds, ms per round, the median of the rounds in
    which every slot of every partition decoded, output tok/s."""
    import torch
    reqs = runtime_requests(cfg)
    for tid, r in reqs:
        runtime.submit(tid, r)
    rounds, full = [], []
    t_start = time.perf_counter()
    while runtime.pending() or runtime.n_active or runtime._draining:
        if migrate is not None and len(rounds) == MIGRATE_AFTER:
            runtime.migrate(*migrate)
        both = all(s.n_active == s.batch_slots for s in runtime.sessions)
        t0 = time.perf_counter()
        runtime.step()
        torch.cuda.synchronize()
        rounds.append(time.perf_counter() - t0)
        if both:
            full.append(rounds[-1])
        if len(rounds) > 400:
            fail("[runtime] the runtime did not drain in 400 rounds")
    wall = time.perf_counter() - t_start
    outs = {r.uid: list(r.out) for _, r in reqs}
    if any(not r.done or len(r.out) != MAX_NEW for _, r in reqs):
        fail(f"[runtime] {sum(r.done for _, r in reqs)}/{len(reqs)} "
             "requests completed in full")
    n_tok = sum(len(o) for o in outs.values())
    return {"outs": outs, "wall_s": wall, "rounds": len(rounds),
            "ms_per_round": 1e3 * sum(rounds) / len(rounds),
            "full_round_ms_median":
                1e3 * sorted(full)[len(full) // 2] if full else None,
            "tok_s": n_tok / wall, "tokens": n_tok}


def profile_runtime_round(runtime, cfg, rec, warm_rounds=3):
    """After a run: submit its requests again (new uids), step
    ``warm_rounds`` rounds so that every slot decodes, then one round
    under torch.profiler. Adds to ``rec`` the round's device busy ms, the
    ms in which kernels of two or more streams ran at once, and the idle
    share against the run's full-round median (the profiler slows the
    host, so its own wall is not used)."""
    import torch
    for tid, r in runtime_requests(cfg):
        r.uid += 1000
        runtime.submit(tid, r)
    for _ in range(warm_rounds):
        runtime.step()
    torch.cuda.synchronize()
    spans = profiled(runtime.step)
    busy = busy_us(spans) / 1e3
    rec.update(profiled_round_busy_ms=busy,
               profiled_round_multi_stream_ms=multi_stream_us(spans) / 1e3,
               profiled_round_streams=len({st for _, _, st in spans}),
               profiled_round_kernels=len(spans))
    if rec["full_round_ms_median"]:
        rec["idle_share"] = 1.0 - busy / rec["full_round_ms_median"]


def runtime_launches_expected(runtime, cfg) -> dict:
    """Kernel launches of a run from its partitions' prefill and decode
    counts: per step (prefill or decode) a dense partition launches A for
    its 7 linears per layer and the head, a sparse24 partition D for the
    7 per layer and A for the head; each prefill launches B per layer."""
    want = dict.fromkeys(("gemm", "flash_attention", "paged_attention",
                          "sparse24_gemm", "block24_gemm"), 0)
    per_layer = 7 * cfg.num_layers
    for sess, tr in zip(runtime.sessions, runtime.tracers):
        counts = tr.counts()
        pre, dec = counts.get("prefill", 0), counts.get("decode", 0)
        steps = pre + dec
        want["flash_attention"] += cfg.num_layers * pre
        if sess.policy.sparsity == "sparse24":
            want["sparse24_gemm"] += per_layer * steps
            want["gemm"] += steps
        else:
            want["gemm"] += (per_layer + 1) * steps
    return want


def runtime_report(tag, runtime, rec, launches, want) -> dict:
    from repro_torch.runtime import traceview
    rep = runtime.report()
    merged = runtime.merged_tracer()
    ov = merged.overlap_summary()
    tenants = [{"tenant": t.tenant_id, "partition": t.partition,
                "completed": t.completed,
                "turnaround_steps": t.mean_turnaround_steps,
                "queue_wait_steps": t.mean_queue_wait_steps,
                "p50_latency_s": t.p50_latency_s,
                "p99_latency_s": t.p99_latency_s, "slo": t.slo,
                "slo_attainment": t.slo_attainment}
               for t in rep.tenants]
    doc = traceview.to_chrome_trace(merged)
    slug = "".join(c if c.isalnum() else "_" for c in tag)
    path = ROOT / "build" / "runtime_traces" / f"{slug}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    traceview.export_chrome_trace(merged, str(path))
    check = traceview.validate(traceview.load(str(path)))
    if check != traceview.validate(doc) or check["n_slices"] < \
            merged.counts().get("decode", 0):
        fail(f"[runtime] {tag}: the exported Chrome trace does not "
             f"validate: {check}")
    groups = traceview.overlapping_groups(doc)
    out = {k: v for k, v in rec.items() if k != "outs"}
    out.update(run=tag, policies=rep.policies, steps=rep.steps,
               overlap_groups_formed=ov["groups"],
               overlap_groups_in_trace=len(groups),
               overlap_groups_overlapping_in_trace=sum(groups.values()),
               launches=launches, launches_expected=want,
               fairness=rep.fairness, tenants=tenants, trace=check,
               migrations=[m.to_dict() for m in runtime.migrations])
    print(f"[runtime] {tag}: {json.dumps(out)}", flush=True)
    print("\n".join(f"[runtime]   {line}"
                    for line in rep.summary().splitlines()), flush=True)
    return out


def runtime_phase(params, packed, cfg):
    """``ServingRuntime`` on the card, llama3-8b at full depth, the
    weights made above (and the 2:4 copy packed by the sparse24 run). Run
    A: partitions ``bf16:dense:hopper`` and ``bf16:sparse24:hopper``
    (logical partitions of the one card, sharing its weights), 4 slots
    each, three tenants, twelve requests, lane overlap on; run B: the
    same with overlap off; then each partition's requests through a
    plain ``ServeSession`` of its policy. Run C: two dense partitions, all
    tenants pinned to p0, ``migrate("batch", 1)`` after MIGRATE_AFTER
    rounds, against the same run without the migration. Then one
    WorkloadTrace replayed with overlap on and off. Gates: tokens equal
    across A, B and the plain sessions, C equal to C without migration,
    the replays' checksums equal, every request complete, launches of A,
    B and D as expected, C and E never, the exported traces valid."""
    import torch
    from repro_torch.core import execution as ex
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.runtime import workload as wl
    from repro_torch.runtime.serve_loop import ServeSession
    from repro_torch.runtime.server import ServingRuntime

    auto = ex.resolve_policy(SLOTS, cfg.d_model, cfg.d_ff,
                             precision=cfg.precision, latency_sensitive=True,
                             tenants=SLOTS, backend="hopper")
    adv = ex.get_default_advisor()
    print(f"[runtime] resolve_policy('auto') on the card for the decode "
          f"GEMM ({SLOTS}, {cfg.d_model}, {cfg.d_ff}): "
          f"{auto.full_spec()} (grid tiles "
          f"{ex.grid_tiles(SLOTS, cfg.d_ff)}, {adv.n_cores} SMs, fill "
          f"{ex.grid_tiles(SLOTS, cfg.d_ff) / adv.n_cores:.3f}); "
          + "; ".join(auto.rationale), flush=True)
    rt = RuntimeCfg(use_pallas=True)

    def runtime(policies, overlap, **kw):
        return ServingRuntime(params, cfg,
                              runtime_spec(policies, overlap, **kw), rt=rt,
                              device="cuda", packed_params=packed)

    # runs A and B in turns (A, B, B, A): a difference between them is
    # read against the spread between the two turns of each; the first
    # turn of each is profiled afterwards
    results, runs = {}, {}
    for tag, overlap in (("runtime A overlap", True),
                         ("runtime B no overlap", False),
                         ("runtime B no overlap, turn 2", False),
                         ("runtime A overlap, turn 2", True)):
        rtm = runtime(RUNTIME_POLICIES, overlap)
        torch.cuda.synchronize()
        zero_launch_counts()
        rec = drive_runtime(rtm, cfg)
        launches = launch_counts()
        want = runtime_launches_expected(rtm, cfg)
        results[tag] = runtime_report(tag, rtm, rec, launches, want)
        if "turn 2" not in tag:
            profile_runtime_round(rtm, cfg, rec)
            print(f"[runtime] {tag}: one profiled round with every slot "
                  f"decoding: {rec['profiled_round_kernels']} kernels on "
                  f"{rec['profiled_round_streams']} streams, device busy "
                  f"{rec['profiled_round_busy_ms']:.2f} ms, two or more "
                  f"streams at once "
                  f"{rec['profiled_round_multi_stream_ms']:.3f} ms; idle "
                  f"share {rec.get('idle_share')} of the "
                  f"{rec['full_round_ms_median']:.1f} ms full-round median",
                  flush=True)
        if launches != want:
            fail(f"[runtime] {tag}: kernel launches {launches}, expected "
                 f"{want}")
        runs[tag] = (rec, dict(rtm.tenant_partition))
        del rtm
        torch.cuda.empty_cache()
    (a, placement) = runs["runtime A overlap"]
    same = min(sum(a["outs"][u] == rec["outs"][u] for u in a["outs"])
               for rec, _ in runs.values())
    print(f"[runtime] tokens of run A (overlap) equal run B (no overlap) "
          f"and both second turns for {same}/{len(a['outs'])} requests",
          flush=True)
    if same != len(a["outs"]):
        fail("[runtime] lane overlap changed the tokens")
    # each partition's requests through a plain session of its policy
    plain = {}
    for i, pol in enumerate(RUNTIME_POLICIES):
        reqs = [r for tid, r in runtime_requests(cfg) if placement[tid] == i]
        sess = ServeSession(packed if "sparse24" in pol else params, cfg,
                            batch_slots=SLOTS, max_len=MAX_LEN, rt=rt,
                            policy=pol, device="cuda")
        for r in reqs:
            sess.submit(r)
        sess.run()
        plain.update({r.uid: list(r.out) for r in reqs})
        del sess
    same = sum(a["outs"][u] == plain[u] for u in a["outs"])
    print(f"[runtime] tokens of run A equal a plain ServeSession of each "
          f"partition's policy for {same}/{len(a['outs'])} requests "
          f"(placement {placement})", flush=True)
    if same != len(a["outs"]):
        fail("[runtime] the runtime's tokens differ from a plain session's")

    dense2 = (RUNTIME_POLICIES[0], RUNTIME_POLICIES[0])
    outs = {}
    for tag, mig in (("runtime C migrate", ("batch", 1)),
                     ("runtime C no migrate", None)):
        rtm = runtime(dense2, True, pins=0)
        zero_launch_counts()
        rec = drive_runtime(rtm, cfg, migrate=mig)
        launches = launch_counts()
        want = runtime_launches_expected(rtm, cfg)
        results[tag] = runtime_report(tag, rtm, rec, launches, want)
        if launches != want:
            fail(f"[runtime] {tag}: kernel launches {launches}, expected "
                 f"{want}")
        if mig is not None:
            phases = [e.meta["phase"]
                      for e in rtm.merged_tracer().events("migrate")]
            print(f"[runtime] {tag}: migrate events {phases}; handoffs "
                  f"{rtm.migrations[0].slots_handed_off}", flush=True)
            if not all(p in phases for p in ("start", "handoff", "done")) \
                    or not results[tag]["trace"]["migration_flows"]:
                fail(f"[runtime] {tag}: the tracers lack the migrate "
                     "start/handoff/done events or the trace its flows")
        outs[tag] = rec["outs"]
        del rtm
        torch.cuda.empty_cache()
    same = sum(outs["runtime C migrate"][u] == outs["runtime C no migrate"][u]
               for u in outs["runtime C no migrate"])
    print(f"[runtime] tokens of run C (migrate batch -> p1 mid-flight) "
          f"equal the run without migration for {same}/"
          f"{len(outs['runtime C no migrate'])} requests", flush=True)
    if same != len(outs["runtime C no migrate"]):
        fail("[runtime] the live migration changed the tokens")

    trace = wl.generate(wl.WorkloadSpec(
        tenants=len(RUNTIME_TENANTS), arrival="poisson", rate=0.75, steps=8,
        prompt_len=(min(PROMPT_LENS), max(PROMPT_LENS)),
        max_new=(MAX_NEW, MAX_NEW), vocab=cfg.vocab_size,
        slos=tuple(slo for _, slo in RUNTIME_TENANTS), seed=SEED))
    sums = {}
    for overlap in (True, False):
        rtm = runtime(RUNTIME_POLICIES, overlap, tenants=False)
        t0 = time.perf_counter()
        done = wl.run_trace(rtm, trace)
        torch.cuda.synchronize()
        sums[overlap] = wl.token_checksum(done)
        print(f"[runtime] replay of a WorkloadTrace ({len(trace.events)} "
              f"arrivals, prompts "
              f"{sorted(len(e.prompt) for e in trace.events)}, "
              f"{MAX_NEW} new tokens) overlap={overlap}: "
              f"{len(done)} requests in {rtm.step_count} rounds, "
              f"{time.perf_counter() - t0:.2f}s, "
              f"tokens_checksum={sums[overlap]}", flush=True)
        if len(done) != len(trace.events):
            fail("[runtime] the replay did not complete every request")
        del rtm
    if sums[True] != sums[False]:
        fail("[runtime] the replay's checksums differ with overlap on/off")
    torch.cuda.empty_cache()
    return {tag: {"launches": r["launches"]} for tag, r in results.items()}



def is_port_gemm(kernel_name: str) -> bool:
    """Kernels A, D and E by their CUDA names (this tree's shared tile
    kernel, or the per-kernel names of earlier trees)."""
    return any(k in kernel_name for k in ("tile_kernel", "gemm_kernel",
                                          "sparse24_kernel"))


def short_name(kernel_name: str) -> str:
    """A kernel's name without namespaces and return type, cut to 70
    characters (the tile kernels differ only in their template
    arguments)."""
    for noise in ("void ", "(anonymous namespace)::", "tile_gemm::",
                  "at::native::"):
        kernel_name = kernel_name.replace(noise, "")
    return kernel_name[:70]


def profile_decode(sess, requests, step_ms: float, steps: int = 4):
    """Device time of a full-batch decode step under torch.profiler: the
    union of kernel intervals per step and the kernels that take most of
    it. ``step_ms`` is the step's wall time measured by ``drive`` (no
    profiler); one minus their ratio is the device's idle share. On the
    host side: the operators with the most self CPU time per step, and
    the CUDA runtime calls per step that wait for the device or copy
    (synchronise, memcpy)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for r in requests[:sess.batch_slots]:
        sess.admit(r)
    sess.decode_once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            sess.decode_once()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.end - e.time_range.start
    spans = device_spans(prof)
    busy = busy_us(spans)
    if not spans:
        print("[profile] no device events from torch.profiler: device "
              "busy time not measured", flush=True)
        return {"device_busy_ms_per_step": None, "device_idle_share": None}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    busy_ms = busy / 1e3 / steps
    host = [a for a in prof.key_averages()
            if not str(getattr(a, "device_type", "")).endswith("CUDA")]
    host_top = sorted((a for a in host if a.key.startswith("aten::")),
                      key=lambda a: -a.self_cpu_time_total)[:6]
    waits = {a.key: a.count / steps for a in host
             if "Synchronize" in a.key or "Memcpy" in a.key}
    gemm_us = sum(t for n, t in by_name.items() if is_port_gemm(n))
    out = {"device_busy_ms_per_step": busy_ms,
           "device_idle_share": 1.0 - busy_ms / step_ms,
           "kernels_per_step": len(spans) / steps,
           "port_gemm_ms_per_step": gemm_us / 1e3 / steps,
           "top_kernels_ms_per_step": {
               short_name(n): t / 1e3 / steps for n, t in top},
           "top_host_ops_self_ms_per_step": {
               a.key: a.self_cpu_time_total / 1e3 / steps for a in host_top},
           "host_ops_per_step": sum(a.count for a in host
                                    if a.key.startswith("aten::")) / steps,
           "runtime_waits_and_copies_per_step": waits}
    print(f"[profile] {json.dumps(out)}", flush=True)
    return out


def check_serve(tag, run, base, launches):
    tol = LOGIT_TOL[tag.split(":")[0]]
    check_completed(tag, run)
    on_path = PATH_KERNELS[tag.split(":")[1]]
    for name, n in launches.items():
        if (n <= 0) if name in on_path else (n != 0):
            fail(f"{tag}: kernel {name} was launched {n} times on the main "
                 f"path (its kernels: {', '.join(on_path)})")
    # prefill: the same prompt under both backends; decode: the torch
    # backend's step from the hopper run's own state (tokens, caches)
    pre = (run["first"]["prefill"] - base["first"]["prefill"]).abs().max()
    rows = run["first"]["decode_rows"]
    dec = (run["first"]["decode"][rows] - run["first"]["decode_twin"][rows]
           ).abs().max()
    pre, dec = float(pre), float(dec)
    print(f"[serve] {tag}: logits vs torch backend: first prefill "
          f"max_abs_err={pre:.4f}, first decode max_abs_err={dec:.4f} "
          f"(tolerance {tol})", flush=True)
    if not (pre <= tol and dec <= tol):
        fail(f"{tag}: logits differ from the torch backend beyond {tol}")
    # greedy tokens: a request's first flip must sit at a near-tie, a step
    # whose top-2 margin is under twice the logit tolerance (each of the
    # two logits may move by tol); print where each request first met one
    flips = []
    for uid, want in base["outs"].items():
        got = run["outs"][uid]
        flip = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                    None)
        if flip is None:
            continue
        margin = [min(run["margins"][(uid, i)], base["margins"][(uid, i)])
                  for i in range(flip + 1)]
        if margin[flip] >= 2 * tol:
            fail(f"{tag}: request {uid} token {flip} differs from the torch "
                 f"backend at top-2 margin {margin[flip]:.3f} >= {2 * tol}")
        first_tie = next(i for i, m in enumerate(margin) if m < 2 * tol)
        flips.append(f"request {uid}: first near-tie at token {first_tie}, "
                     f"first flip at token {flip} (margin {margin[flip]:.3f})")
    same = sum(run["outs"][u] == base["outs"][u] for u in base["outs"])
    print(f"[serve] {tag}: greedy tokens equal to the torch backend for "
          f"{same}/{N_REQUESTS} requests" + ("; " if flips else "")
          + "; ".join(flips), flush=True)
    res = dict(run_times(tag, run),
               torch_backend_decode_ms_per_step=mean_ms(base["decode_s"]),
               torch_backend_prefill_ms=mean_ms(base["prefill_s"]),
               launches=launches, first_prefill_err=pre,
               first_decode_err=dec)
    print(f"[serve-time] {json.dumps(res)}", flush=True)
    return res


# ---------------------------------------------------------------------------

def kernel_line(gemm_rows, flash_rows, sparse24_rows, block24_rows,
                paged_rows, sweep_launches, serve):
    def pick(rows, **match):
        return next(r for r in rows
                    if all(r[k] == v for k, v in match.items()))

    g = pick(gemm_rows, label="decode_mlp", type="bf16")
    f = pick(flash_rows, S=128)
    d = pick(sparse24_rows, label="decode_gate_up", values="bf16")
    e = pick(block24_rows, M=4, block=128)
    out = []
    for name, row, source, replaces, shape in (
            ("gemm", g, "src/repro_torch/kernels/csrc/gemm.cu",
             "src/repro/kernels/fp8_matmul.py:56",
             f"M={g['M']} K={g['K']} N={g['N']} bf16->{g['out']}"),
            ("flash_attention", f,
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:76",
             f"B={f['B']} h={f['h']} kvh={f['kvh']} S={f['S']} "
             f"hd={f['hd']} causal bf16"),
            ("sparse24_gemm", d,
             "src/repro_torch/kernels/csrc/sparse24_gemm.cu",
             "src/repro/kernels/sparse24_matmul.py:68",
             f"M={d['M']} K={d['K']} N={d['N']} packed bf16->bf16")):
        by_policy = {p: r["launches"][name] for p, r in serve.items()}
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "launches": sum(by_policy.values()),
                    "launches_by_policy": by_policy,
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"], "shape": shape})
    # kernel E is on no serving path (its counter read 0 in every policy's
    # run, which check_serve requires): its launches are those of its one
    # entry point, ops.block24_matmul, driven in block24_phase
    out.append({"name": "block24_gemm", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/block24_gemm.cu",
                "replaces": "src/repro/kernels/sparse24_matmul.py:104",
                "launches": e["entry_point_launches"],
                "launches_by_policy": {p: r["launches"]["block24_gemm"]
                                       for p, r in serve.items()},
                "path": "repro_torch.kernels.ops.block24_matmul",
                "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                "bound_by": e["bound_by"], "library_ms": e["library_ms"],
                "shape": f"M={e['M']} K={e['K']} N={e['N']} "
                         f"block={e['block']} bf16->bf16"})
    # kernel C is on no serving path either (the paged decode step gathers
    # pages with tensor ops, as the reference's does): its launches are
    # those of its entry points, paged_decode_attention (paged_phase, and
    # on the paged run's live pools) and sweep_paged_tilings
    c = pick(paged_rows, label="serving_ps16")
    paged = serve[PAGED_TAG]
    out.append({"name": "paged_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
                "replaces": "src/repro/kernels/paged_attention.py:135",
                "launches": c["entry_point_launches"]
                + paged["live_pool_launches"] + sweep_launches,
                "launches_by_policy": {p: r["launches"]["paged_attention"]
                                       for p, r in serve.items()},
                "path": "repro_torch.kernels.paged_attention."
                        "paged_decode_attention and sweep_paged_tilings",
                "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": c["library_ms"],
                "shape": f"B={c['B']} h={c['h']} kvh={c['kvh']} "
                         f"hd={c['hd']} ps={c['page_size']} "
                         f"mp={c['max_pages']} lengths {c['lengths']} "
                         "bf16 pools"})
    return {"kernels": out}


def parse_args(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build, check and time kernels A to E only, "
                         "print their rows and no result line")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the src/ directory whose repro_torch to build and "
                         "measure (default: this checkout's); with "
                         "--kernels-only, another commit's checkout can be "
                         "timed by the same code in the same call")
    return ap.parse_args(argv)


def kernels_only(smi: str) -> int:
    """Kernels A to E at their phases' shapes: checked, timed, one summary
    line (label, type, ms, library ms, plan) per kernel."""
    build_phase()
    summary = {"nvidia_smi": smi, "src": str(ARGS.src),
               "gemm": gemm_phase(), "flash": flash_phase(),
               "sparse24": sparse24_phase(), "block24": block24_phase(),
               "paged": paged_phase()}
    keep = ("label", "M", "K", "N", "S", "type", "values", "block", "ms",
            "event_ms", "library_ms", "bound_ms", "plan", "host_us_per_call")
    for name in ("gemm", "flash", "sparse24", "block24", "paged"):
        summary[name] = [{k: r[k] for k in keep if k in r}
                         for r in summary[name]]
    print(f"[kernels-only] {json.dumps(summary)}", flush=True)
    return 0


ARGS = None


def main() -> int:
    global ARGS
    ARGS = parse_args(sys.argv[1:])
    import torch
    smi = preflight(ARGS.src.resolve())
    if ARGS.kernels_only:
        return kernels_only(smi)
    build_phase()
    gemm_rows = gemm_phase()
    flash_rows = flash_phase()
    sparse24_rows = sparse24_phase()
    block24_rows = block24_phase()
    paged_rows = paged_phase()
    _, sweep_launches = sweep_phase()
    streams_phase()
    serve = serve_phase()
    print(json.dumps(kernel_line(gemm_rows, flash_rows, sparse24_rows,
                                 block24_rows, paged_rows, sweep_launches,
                                 serve)), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
