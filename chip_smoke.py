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
twice LOGIT_TOL). A profiled decode step gives the device's busy time and
idle share. Kernel E (block-2:4) is on no serving path; its one entry
point, ``kernels.ops.block24_matmul``, is driven at its phase's shapes.

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

# H100 SXM data-sheet peaks (dense): bytes/s and operations/s per type.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "e4m3": 1979e12, "e5m2": 1979e12}


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


def bound_ms(n_bytes: float, n_ops: float, kind: str):
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = n_ops / PEAK_OPS_S[kind]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


# ---------------------------------------------------------------------------
# Kernel A: the GEMM against its plain version
# ---------------------------------------------------------------------------

# (label, M, K, N): decode (M = slots), the LM head, prefill at both prompt
# lengths, and a ragged K.
GEMM_SHAPES = (
    ("decode_mlp", 4, 4096, 14336),
    ("decode_head", 4, 4096, 128256),
    ("prefill_mlp", 128, 4096, 14336),
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
        for kind in GEMM_TYPES:
            x, w = gemm_inputs(M, K, N, kind, gen)
            for out_dtype in (torch.float32, torch.bfloat16):
                got = fm.fp8_matmul(x, w, out_dtype)
                want = fm.fp8_matmul_plain(x, w, out_dtype)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                name = str(out_dtype).split(".")[-1]
                rel = err / max(scale, 1e-30)
                ok = bool(torch.isfinite(got).all()) and \
                    rel <= GEMM_REL_TOL[name]
                print(f"[gemm] {label} M={M} K={K} N={N} {kind}->{name}: "
                      f"max_abs_err={err:.3e} rel={rel:.2e} "
                      f"{'ok' if ok else 'MISMATCH'}", flush=True)
                if not ok:
                    fail(f"GEMM {label} {kind}->{name} disagrees with its "
                         f"plain version (rel {rel:.2e})")
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
            ms = time_ms(lambda: fm.fp8_matmul(x, w, out_dtype), iters)
            plain = time_ms(lambda: fm.fp8_matmul_plain(x, w, out_dtype), 5)
            lib, lib_note = None, None
            if kind == "bf16":
                lib = time_ms(lambda: torch.matmul(x, w), iters)
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
                   "bound_by": by}
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
        ms = time_ms(lambda: torch._scaled_mm(
            xp, wc, scale_a=one, scale_b=one, out_dtype=out_dtype), iters)
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


def flash_phase():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []
    for B, h, kvh, S, hd in FLASH_SHAPES:
        q = torch.randn((B, h, S, hd), generator=gen, device="cuda").to(
            torch.bfloat16)
        k = torch.randn((B, kvh, S, hd), generator=gen, device="cuda").to(
            torch.bfloat16)
        v = torch.randn((B, kvh, S, hd), generator=gen, device="cuda").to(
            torch.bfloat16)
        got = fa.flash_attention(q, k, v, causal=True)
        want = fa.flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= FLASH_TOL
        print(f"[flash] B={B} h={h} kvh={kvh} S={S} hd={hd} causal: "
              f"max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            fail(f"flash attention S={S} disagrees with its plain version "
                 f"(max_abs_err {err:.3e} > {FLASH_TOL})")
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True), 100)
        plain = time_ms(
            lambda: fa.flash_attention_plain(q, k, v, causal=True), 20)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 100)
        n_bytes = 2 * (2 * B * h * S * hd + 2 * B * kvh * S * hd)
        bms, by = bound_ms(n_bytes, flash_flops(B, h, S, hd), "bf16")
        row = {"label": f"prefill_S{S}", "B": B, "h": h, "kvh": kvh, "S": S,
               "hd": hd, "max_abs_err": err, "ms": ms, "plain_ms": plain,
               "library_ms": lib, "bound_ms": bms, "bound_by": by}
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
        for kind in SPARSE24_TYPES:
            x, pw = packed_inputs(M, K, N, kind, gen)
            for out_dtype in (torch.float32, torch.bfloat16):
                got = sm.sparse24_matmul(x, pw.values, pw.meta, out_dtype)
                want = sm.sparse24_matmul_plain(x, pw.values, pw.meta,
                                                out_dtype)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                name = str(out_dtype).split(".")[-1]
                rel = err / max(scale, 1e-30)
                ok = bool(torch.isfinite(got).all()) and \
                    rel <= GEMM_REL_TOL[name]
                print(f"[sparse24] {label} M={M} K={K} N={N} {kind}->{name}: "
                      f"max_abs_err={err:.3e} rel={rel:.2e} "
                      f"{'ok' if ok else 'MISMATCH'}", flush=True)
                if not ok:
                    fail(f"packed 2:4 GEMM {label} {kind}->{name} disagrees "
                         f"with its plain version (rel {rel:.2e})")
            # times at the main path's output type (the activation, bf16)
            out_dtype = torch.bfloat16
            err = (sm.sparse24_matmul(x, pw.values, pw.meta, out_dtype).float()
                   - sm.sparse24_matmul_plain(x, pw.values, pw.meta,
                                              out_dtype).float()
                   ).abs().max().item()
            iters = 50
            ms = time_ms(lambda: sm.sparse24_matmul(x, pw.values, pw.meta,
                                                    out_dtype), iters)
            plain = time_ms(lambda: sm.sparse24_matmul_plain(
                x, pw.values, pw.meta, out_dtype), 5)
            w_dense = sp.unpack_24(pw.values, pw.meta).to(torch.bfloat16)
            lib = time_ms(lambda: torch.matmul(x, w_dense), iters)
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
                   "bound_ms": bms, "bound_by": by}
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
        for out_dtype in (torch.float32, torch.bfloat16):
            got = sm.block24_matmul(x, packed, kept, block, out_dtype)
            want = sm.block24_matmul_plain(x, packed, kept, block, out_dtype)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            name = str(out_dtype).split(".")[-1]
            rel = err / max(scale, 1e-30)
            ok = bool(torch.isfinite(got).all()) and rel <= GEMM_REL_TOL[name]
            print(f"[block24] M={M} K={K} N={N} block={block} bf16->{name}: "
                  f"max_abs_err={err:.3e} rel={rel:.2e} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"block-2:4 GEMM M={M} block={block} ->{name} disagrees "
                     f"with its plain version (rel {rel:.2e})")
        out_dtype = torch.bfloat16
        err = (sm.block24_matmul(x, packed, kept, block, out_dtype).float()
               - sm.block24_matmul_plain(x, packed, kept, block,
                                         out_dtype).float()
               ).abs().max().item()
        ms = time_ms(lambda: sm.block24_matmul(x, packed, kept, block,
                                               out_dtype), 50)
        plain = time_ms(lambda: sm.block24_matmul_plain(
            x, packed, kept, block, out_dtype), 5)
        cols = torch.cat([torch.arange(i * block, (i + 1) * block,
                                       device="cuda") for i in kept])
        xk = x[:, cols].contiguous()
        lib = time_ms(lambda: torch.matmul(xk, packed), 50)
        n_bytes = M * (K // 2) * 2 + (K // 2) * N * 2 + M * N * 2
        bms, by = bound_ms(n_bytes, 2.0 * M * N * (K // 2), "bf16")
        row = {"label": f"M{M}_block{block}", "M": M, "K": K, "N": N,
               "block": block, "out": "bfloat16", "max_abs_err": err,
               "ms": ms, "plain_ms": plain, "library_ms": lib,
               "library_note": "torch.matmul on x's kept columns gathered "
                               "beforehand (the gather is left out: no one "
                               "call computes E's function)",
               "bound_ms": bms, "bound_by": by,
               "entry_point_launches": entry_launches}
        rows.append(row)
        print(f"[block24-time] {json.dumps(row)}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# Set-up
# ---------------------------------------------------------------------------

def preflight() -> str:
    """Refuse to run without the port's sources or a CUDA device."""
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"[smoke] the port's sources are not under {SRC}: run this "
              "script from a checkout of the repository", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(SRC))
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
PATH_KERNELS = {"dense": ("gemm", "flash_attention"),
                "sparse24": ("gemm", "flash_attention", "sparse24_gemm")}


def launch_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fp8_matmul as fm
    from repro_torch.kernels import sparse24_matmul as sm
    return {"gemm": fm.LAUNCHES, "flash_attention": fa.LAUNCHES,
            "sparse24_gemm": sm.LAUNCHES,
            "block24_gemm": sm.BLOCK24_LAUNCHES}


def zero_launch_counts() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fp8_matmul as fm
    from repro_torch.kernels import sparse24_matmul as sm
    fm.LAUNCHES = fa.LAUNCHES = sm.LAUNCHES = sm.BLOCK24_LAUNCHES = 0


def _margin(row) -> float:
    import torch
    top = torch.topk(row.float(), 2).values
    return float(top[0] - top[1])


def drive(sess, requests, twin=None):
    """Serve ``requests`` the way ``ServeSession.run`` does, one admission
    and one decode step at a time, timing each (host clock around work
    that ends in a device synchronise) and keeping what the comparison
    needs: the first prefill's and first decode's logits, and the top-2
    margin behind every token. ``twin(params, tokens, caches, pos)`` is
    run on a copy of the state the first decode step starts from, so its
    logits compare with that step's on identical inputs."""
    import numpy as np
    import torch
    for r in requests:
        sess.submit(r)
    first = {}
    margins = {}
    prefill_s, decode_s = [], []
    t_start = time.perf_counter()
    while sess.queue or sess.n_active:
        while sess.queue and sess.has_free_slot():
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
    torch.cuda.empty_cache()
    results["bf16:sparse24:hopper"] = serve_sparse24(params, cfg, requests)
    del params
    torch.cuda.empty_cache()
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
            "sparse24_gemm": per_step * steps, "block24_gemm": 0}
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
    return res


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


def profile_decode(sess, requests, step_ms: float, steps: int = 4):
    """Device time of a full-batch decode step under torch.profiler: the
    union of kernel intervals per step and the kernels that take most of
    it. ``step_ms`` is the step's wall time measured by ``drive`` (no
    profiler); one minus their ratio is the device's idle share."""
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
    spans, by_name = [], {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    if not spans:
        print("[profile] no device events from torch.profiler: device "
              "busy time not measured", flush=True)
        return {"device_busy_ms_per_step": None, "device_idle_share": None}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    busy_ms = busy / 1e3 / steps
    gemm_us = sum(t for n, t in by_name.items()
                  if "gemm_kernel" in n or "sparse24_kernel" in n)
    out = {"device_busy_ms_per_step": busy_ms,
           "device_idle_share": 1.0 - busy_ms / step_ms,
           "kernels_per_step": len(spans) / steps,
           "port_gemm_ms_per_step": gemm_us / 1e3 / steps,
           "top_kernels_ms_per_step": {
               n[:60]: t / 1e3 / steps for n, t in top}}
    print(f"[profile] {json.dumps(out)}", flush=True)
    return out


def check_serve(tag, run, base, launches):
    tol = LOGIT_TOL[tag.split(":")[0]]
    n_done = len(run["outs"])
    if n_done != N_REQUESTS or any(len(o) != MAX_NEW
                                   for o in run["outs"].values()):
        fail(f"{tag}: {n_done}/{N_REQUESTS} requests completed")
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
    n_tok = sum(len(o) for o in run["outs"].values())
    dec_ms = sorted(1e3 * t for t in run["decode_s"])
    res = {"policy": tag, "requests": n_done, "tokens": n_tok,
           "prefill_ms": 1e3 * sum(run["prefill_s"]) / len(run["prefill_s"]),
           "decode_ms_per_step": sum(dec_ms) / len(dec_ms),
           "decode_ms_median": dec_ms[len(dec_ms) // 2],
           # the highest percentile with ten samples beyond it
           "decode_ms_p67": dec_ms[max(0, len(dec_ms) - 11)],
           "decode_steps": len(dec_ms),
           "tok_s": n_tok / run["wall_s"], "wall_s": run["wall_s"],
           "torch_backend_decode_ms_per_step":
               1e3 * sum(base["decode_s"]) / len(base["decode_s"]),
           "torch_backend_prefill_ms":
               1e3 * sum(base["prefill_s"]) / len(base["prefill_s"]),
           "launches": launches, "first_prefill_err": pre,
           "first_decode_err": dec}
    print(f"[serve-time] {json.dumps(res)}", flush=True)
    return res


# ---------------------------------------------------------------------------

def kernel_line(gemm_rows, flash_rows, sparse24_rows, block24_rows, serve):
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
    return {"kernels": out}


def main() -> int:
    import torch
    smi = preflight()
    build_phase()
    gemm_rows = gemm_phase()
    flash_rows = flash_phase()
    sparse24_rows = sparse24_phase()
    block24_rows = block24_phase()
    serve = serve_phase()
    print(json.dumps(kernel_line(gemm_rows, flash_rows, sparse24_rows,
                                 block24_rows, serve)), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
