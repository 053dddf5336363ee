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
gives the device's busy time and idle share. ``[sample]`` serves the same
requests under ``bf16:dense:hopper`` at temperature 0.7 from seed 0
(``core/prng.py``'s threefry2x32 run on the card, its bits held to the
CPU's bit for bit): dense, where every admission's and decode step's
token must be the argmax of the torch backend's logits, teacher forced on
a copy of the same state, over T plus the step's own Gumbel draw unless
their top two lie within LOGIT_TOL / T; paged, whose tokens must equal
the dense run's; launches equal to the greedy runs'; the refusal of
``speculative=``; and the sampler's kernels and ms per step. Then
speculative decoding (``ServeSession(speculative=...)``,
``bf16:dense:hopper`` verify) in three
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

``[profile]`` (right after ``[sweep]``: ~1 s, ~11 s when it starts the
profiler first) is the card's calibration
run, the paper's own method. ``launch/profile.py --quick --device cuda``
runs as a user runs it, under the default ``torch`` backend, and its
artifact must reload; again with ``--backend hopper``, which must run
kernel A, name ``hopper`` in its artifact and restore the default
backend. Then, under ``hopper``: the occupancy sweep (kernel A in bf16
and e4m3, M = 128·t for t = 1…128 at K = 4096, N = 1024) and the
tile-latency probe, with A's launches held to the timed calls; each
occupancy point and each latency shape held against its plain version
through ``raw_matmul``, and beside its plan and the library's own call
on its operands (``torch.matmul``, ``torch._scaled_mm``); ``_time_fn``'s
device time held within 10% of torch.profiler's at the two largest
points of each precision; ``contention_sweep`` under ``torch``, whose
one-stream dilation must read near 1; the records and ``[sweep]``'s fed
to a fresh ``AutotuneStore``, calibrated on the SM count, saved under
``build/profile/`` and installed (the advisor calibrated exactly when a
knee came out); and the block sweep as an A/A test: kernel A reads no
block shape, so each group's tilings must give the same bits, and the
spread of their times is the timer's noise floor.

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

Then the other attention-style block kinds at their published sizes, each
model's weights freed before the next. ``[moe]`` serves
granite-moe-3b-a800m (40 experts, top 8), every expert GEMM one launch of
kernel A over all experts (``fp8_matmul_batched``), under
``bf16:dense:hopper`` dense and paged and ``fp8:dense:hopper``; its
routing is discontinuous in its input (a bf16 ulp moves a token across
an expert's top-k or capacity cut), so the torch-backend comparison is
made sublayer by sublayer on the same inputs, and the end-to-end logits
and tokens are printed beside it. ``[local]`` serves gemma3-12b (5 local
layers of window 1024 : 1 global, head_dim 256) with one 1040-token
prompt that rolls the windows, dense and paged within LOGIT_TOL of the
torch backend, and a bf16-draft speculative session whose tokens equal
the plain run's; kernel B serves the global layers' prefill at hd 256.
``[moe-top1]`` serves llama4-scout-17b-a16e at its published width with 8
of its 48 layers (16 experts, top 1, and a shared expert whose three
GEMMs run on plain kernel-A launches beside the expert-batched ones;
kernel B at 40 query heads over 8 kv heads) under ``bf16:dense:hopper``
dense and paged, held sublayer by sublayer as ``[moe]`` is.
``[dense-wide]`` serves the widest dense stacks: chameleon-34b whole (48
layers, d 8192, 64 query heads over 8 kv heads: kernel B at group 8; 8
prompts of 128 tokens), deepseek-67b at 4 of its 95 layers (its head of
102400) and llama3-405b at 2 of its 126 (d 16384, d_ff 53248, group 16, a
head of 128256), each under ``bf16:dense:hopper`` dense and paged within
LOGIT_TOL of the torch backend, llama3-405b also under
``fp8:dense:hopper``; then ``python -m repro_torch.launch.serve`` on
chameleon-34b whole, called in this process as a user runs it, whose
tokens must equal the dense run's. Each checks its launches exactly, and
the paged runs equal the dense runs bit for bit.

Then the recurrent block kinds at their published sizes. ``[ssm]``
serves rwkv6-3b (32 rwkv6 layers, d 2560, 40 heads of 64; one prompt of
256 tokens, two scan chunks) under ``bf16:dense:hopper`` dense and paged
(the paged cache pools nothing there) and ``fp8:dense:hopper``;
``[hybrid]`` serves zamba2-1.2b (38 mamba2 layers, 6 x 6 and a tail of
2, and six invocations of one shared attention block whose prefill runs
on kernel B at head_dim 64; one prompt of 512 tokens) dense and paged,
under ``bf16:sparse24:hopper``, in a speculative session with an
``fp8:dense:hopper`` draft at k = 4 whose rejected steps roll the
recurrent states back (tokens equal to the plain run's, some drafts
rejected), and through a slot handoff mid-decode (tokens equal). These
stacks amplify bf16 rounding with depth at this init, so their first
prefill is held to an f32 run of the same weights (the hopper logits no
farther from it than 1.5 times the torch backend's), beside the
sublayer check at LAYER_TOL, the first decode step at LOGIT_TOL and the
near-tie rule for tokens; launches exact, the paged runs bit-equal.

Then ``[train]``: llama3-8b at full width with 8 of its 32 layers
(2.80 B params; bf16 weights, f32 masters and moments, 36.45 GiB of
state), B=4, S=512, ``SyntheticLM`` batches, through
``runtime/train_loop.make_train_step``: three steps under
``bf16:dense:hopper`` and ``fp8:dense:hopper`` against the ``torch``
backend, each arm drawing one init from the seed (the losses and, in
bf16, each leaf's step-0 grad norm within stated tolerances; in fp8
each sublayer of the step-0 forward, teacher forced, within a gap that
a bf16 forward in its place must exceed), one under
``bf16:sparse24:hopper`` (STE, kernel A) and one under
``bf16:dense:hopper_sparse24`` (kernel D, the weight given its masked
gradient), each with its launches as the code implies (every checkpointed
kernel runs twice per step), its ms per step, tokens/s and peak memory,
and one profiled step's device busy time, idle share and kernel A's
share; kernels A and D at the training shapes; a delayed-scaling
``fp8_linear``; ``launch/train.py`` resumed from its final and from a
periodic checkpoint (a supervised restart) bit for bit under
deterministic algorithms; and the
refusal of autograd through every kernel entry point on the card.

Then ``[train-blocks]``: the other block kinds through the same training
path at full width, three steps under ``bf16:dense:hopper`` (one step
profiled) and ``bf16:dense:torch``, each arm from its own init drawn
from the seed (the same bits, held by a checksum): at B=4, S=512,
granite-moe-3b-a800m with 8 of its 32 layers (every expert GEMM one
launch of kernel A over the 40 experts, its backward the per-expert
torch reference; the router, capacity dispatch and aux loss under
autograd), zamba2-1.2b whole (38 mamba2 layers, six calls of the shared
block, the hybrid tail outside the checkpoints), rwkv6-3b with 8 of its
32 layers, musicgen-medium whole (seeded normal frames as its
embeddings input, the token table's gradient exactly zero) and
llama4-scout-17b-a16e with 1 of its 48 layers (top-1 routing at
capacity 80 per group, the shared expert; AdamW's moments in bf16, the
reference's own option, as f32 ones do not fit), chameleon-34b with 1 of
its 48 layers (its embeddings input as musicgen's); and gemma3-12b's one 5
local : 1 global super-layer at B=1, S=2048, where the local layers'
window of 1024 masks (a window-0 control must differ from the windowed
sublayer). Each arm's launches exactly as the code implies (kernel
A's expert-batched ones too); losses (granite's aux loss too) and the
step-0 grad norms of every leaf but a MoE layer's router and experts
within ``[train]``'s tolerances, a recurrent stack that misses them held
instead to an f32 run (hopper no farther from it than 1.5 times torch;
where its gradients miss that too, printed beside how far one bf16 ulp
on the input moves the torch arm's own); every sublayer's forward and
backward under both backends on one input and one cotangent, teacher
forced, within LAYER_TOL (so granite's router and experts are held on
one routing); and ``hopper_experts`` forward and backward at the
training shapes against the torch backend's per-expert path.

Then ``[dist]``: the distributed dry-run (``launch/{dryrun,perf}.py``,
meta tensors over a fake process group, nothing computed) run as a user
runs it on llama3-8b's ``train_4k`` and ``decode_32k`` cells, the
``baseline`` and ``decode_2d_tp`` perf variants (their wire bytes by
collective kind printed) and ``train_4k``'s ``remat_dots`` (below the
dry-run's FLOPs), no record with a fold run gathered; ``[train]``'s own step and ``[serve]``'s
llama3-8b decode step dry-run on a 1x1 mesh, each roofline bound held
at or below 1.05 times the step the card measured (its state bytes
equal to those ``[train]`` allocated; the roofline shares printed); and
one ``[train]`` step under ``remat="dots"``, bit-equal to ``"full"``
with kernel A launched twice per linear.

Every kernel is timed by its device time (torch.profiler) with its
operands out of L2 (rotating copies where they total less than its 50 MB),
checked against its plain version and for bit-equal repeats, and prints its
plan: the tile and K splits of A (and of its expert-batched launch), D
and E, the grid of B, the splits of C's page walk. B and C are timed
beside SDPA, whose CUDA-event means are kept as a second column.
``--kernels-only [--src DIR/src]`` runs just that, on this checkout or
another, so that two commits' kernels can be timed by the same code in
one call; ``--train-blocks-only`` builds and runs ``[train-blocks]``
alone, ``--moe-top1-only`` ``[moe-top1]``, ``--dense-wide-only`` kernels
A and B at ``[dense-wide]``'s shapes and that phase.

Prints one ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, when there is no CUDA device, when the port's sources are
missing, or when any phase fails. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
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

_PEAKS = None


def peaks():
    """(HBM bytes/s, {type: operations/s}): the H100 SXM's dense data-sheet
    peaks (f32 outside the tensor cores), from the port's roofline,
    ``src/repro_torch/launch/roofline.py`` of this checkout, loaded from
    its file (it imports nothing of the port), so every bound of this
    script and of the dry-run has one source."""
    global _PEAKS
    if _PEAKS is None:
        import importlib.util
        name = "_chip_smoke_roofline"
        spec = importlib.util.spec_from_file_location(
            name, SRC / "repro_torch" / "launch" / "roofline.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        _PEAKS = (mod.HBM_BW, dict(mod.PEAK_OPS_S))
    return _PEAKS


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
    copies of them to exceed twice L2. Returns (ms, copies, timer). The
    timer is "profiler" where the time is the kernels' own (``device_ms``),
    so a call that the host issues more slowly than the card runs it is
    still timed as the card runs it. Where torch.profiler lost kernel
    records in every attempt, it is "cuda events" (``time_ms`` over the same
    rotation), which also counts the gaps in which the card waits for the
    host."""
    n_bytes = sum(t.numel() * t.element_size() for t in operands)
    n = 1 if n_bytes >= L2_BYTES else -(-2 * L2_BYTES // n_bytes) + 1
    sets = [tuple(operands)] + [tuple(t.clone() for t in operands)
                                for _ in range(n - 1)]
    turn = iter(range(1 << 62))

    def call():
        return fn(*sets[next(turn) % n])

    ms = device_ms(call, iters)
    if ms is not None:
        return ms, n, "profiler"
    print(f"[smoke] timing {iters} calls with CUDA events instead",
          flush=True)
    return time_ms(call, iters), n, "cuda events"


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


def plan_note(M, N, K, kind, batch: int = 1) -> str:
    """The tile and K splits the planner gives this shape (kernels/
    gemm_plan.py), for ``batch`` members of a batched launch, or a note
    where the checkout under test has none."""
    import torch
    try:
        from repro_torch.kernels import gemm_plan
    except ImportError:
        return "no planner in this checkout"
    extra = (batch,) if batch > 1 else ()
    return gemm_plan.launch_plan(M, N, K, kind, torch.device("cuda", 0),
                                 *extra)[0].describe()


# Pauses (s) before each new attempt at a trace that lost kernel records,
# in every phase. On the H100 torch.profiler now and then records none of
# a session's kernels, or fewer than ran; in some whole runs it records
# none in most sessions from the [train] phase on (PERF.md §7). A retry
# often recovers a trace of a few dozen calls, rarely one of a train step
# (12k-30k kernels), so none is made once the attempts so far took
# PROFILE_RETRY_S; a trace still lost falls back to CUDA events, or is
# reported "not measured".
PROFILE_WAITS_S = (0.25, 1.0)
PROFILE_RETRY_S = 5.0


class Kernel:
    """One device record of a trace: name, start and end (µs), stream."""
    __slots__ = ("name", "start", "end", "stream")

    def __init__(self, name, start, end, stream):
        self.name, self.start, self.end, self.stream = name, start, end, \
            stream


def kernel_records(prof) -> list:
    """The device records of a torch.profiler trace, read from its raw
    Kineto events. ``prof.events()`` would also build the tree of every
    host op, which takes seconds for a train step's trace."""
    return [Kernel(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3,
                   e.device_resource_id())
            for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CUDA")]


def traced(run, complete, what: str):
    """``(prof, kernels)``: a torch.profiler trace of ``run()`` (which ends
    in a device synchronise) and its ``kernel_records``, taken again after
    each pause of PROFILE_WAITS_S while ``complete(kernels)`` is false and
    the attempts so far took less than PROFILE_RETRY_S. None when every
    attempt lost records."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    for wait in (0.0,) + PROFILE_WAITS_S:
        if wait and time.perf_counter() - t0 >= PROFILE_RETRY_S:
            break
        time.sleep(wait)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        kernels = kernel_records(prof)
        if complete(kernels):
            return prof, kernels
        print(f"[smoke] the profile of {what} lost kernel records "
              f"({len(kernels)} recorded); profiling again", flush=True)
    return None


def device_ms(fn, iters: int = 50):
    """Mean device time per call of ``fn``: the summed durations of the
    kernels it launches, from torch.profiler over ``iters`` calls (after
    one warm-up call). Unlike ``time_ms`` it leaves out the gaps in which
    the device waits for the host to issue the next call. Every call
    launches the same kernels, so a profile that recorded no kernel, or
    some kernel not a whole number of times per call, lost records and is
    taken again (``traced``). None when every attempt lost records."""
    import collections
    import torch
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    def complete(kernels):
        counts = collections.Counter(e.name for e in kernels)
        return bool(counts) and not any(n % iters for n in counts.values())
    got = traced(run, complete, f"{iters} calls")
    if got is None:
        return None
    return sum(e.end - e.start for e in got[1]) \
        / 1e3 / iters


def bound_ms(n_bytes: float, n_ops: float, kind: str):
    hbm, ops = peaks()
    t_bytes = n_bytes / hbm
    t_ops = n_ops / ops[kind]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


# ---------------------------------------------------------------------------
# Kernel A: the GEMM against its plain version
# ---------------------------------------------------------------------------

# (label, M, K, N, types): llama3-8b's projections at decode (M = slots:
# gate/up, q/o, k/v, down and the LM head) and at prefill (M = 128, and the
# ragged 77 of the second prompt length), and a ragged K, in every type.
GEMM_TYPES = ("bf16", "e4m3", "e5m2")
GEMM_SHAPES = tuple(shape + (GEMM_TYPES,) for shape in (
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
    ("ragged_k", 77, 4000, 1000)))
# The recurrent stacks' projections, in the two types their policies run
# (bf16, and e4m3 under fp8): zamba2-1.2b's w_B / w_C / w_dt (N = 64, one
# tile wide) at decode and at the 512-token prefill, its w_z / w_x and
# out_proj at decode; rwkv6-3b's d x d time-mix linears, channel-mix key
# and value at decode, and a d x d at its 256-token prefill.
SSM_GEMM_SHAPES = tuple(shape + (GEMM_TYPES[:2],) for shape in (
    ("zamba2_decode_n64", 4, 2048, 64),
    ("zamba2_prefill_n64", 512, 2048, 64),
    ("zamba2_decode_zx", 4, 2048, 4096),
    ("zamba2_decode_out", 4, 4096, 2048),
    ("rwkv6_decode_dd", 4, 2560, 2560),
    ("rwkv6_decode_ck", 4, 2560, 8960),
    ("rwkv6_decode_cv", 4, 8960, 2560),
    ("rwkv6_prefill_dd", 256, 2560, 2560)))
# The widest dense stacks ([dense-wide]), each shape with the types timed:
# chameleon-34b's and deepseek-67b's layer (d 8192, d_ff 22016, 64/8
# heads of 128) and llama3-405b's (d 16384, d_ff 53248, 128/8 heads; its
# down projection's K = 53248 is 3.7 times any other K of the repo) at
# decode and at a 128-token prefill, bf16; llama3-405b's MLP also in e4m3
# at decode (its fp8 run); the three heads (N = 65536, 102400, 128256; the
# last the largest operand of the repo, 2.10 G entries) bf16 -> f32 at
# decode.
WIDE_GEMM_SHAPES = tuple(
    (f"d{d}_{step}_{name}", M, K, N,
     ("bf16", "e4m3") if d == 16384 and M == 4 and name in ("gate_up",
                                                            "down")
     else ("bf16",))
    for step, M in (("decode", 4), ("prefill", 128))
    for d, ff in ((8192, 22016), (16384, 53248))
    for name, K, N in (("gate_up", d, ff), ("down", ff, d), ("qo", d, d),
                       ("kv", d, 1024))) + (
    ("chameleon_decode_head", 4, 8192, 65536, ("bf16",)),
    ("deepseek_decode_head", 4, 8192, 102400, ("bf16",)),
    ("llama3_405b_decode_head", 4, 16384, 128256, ("bf16",)))
# the wide shapes whose bf16 rounding is held to the exact product:
# the down projections, K = 22016 and K = 53248, at the 128-row prefill
ROUNDING_LABELS = ("d8192_prefill_down", "d16384_prefill_down")
# the most kernel A's f32 sums may lean toward zero there, as a share of
# the exact product's RMS: it grows with the K-steps summed into one
# accumulator (-8.5e-6 at K = 22016, -4.2e-5 at K = 53248, ROADMAP §3),
# and past this limit it would near GEMM_REL_TOL's f32 1e-4
ROUNDING_LEAN_LIMIT = 6e-5
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


def gemm_phase(shapes=None):
    """Kernel A at ``shapes`` (default: every shape above), each in its
    types, against its plain version in both output types, repeated bit
    for bit, then timed at the output type the main path uses there
    beside its bound and the library's call; at ROUNDING_LABELS, its bf16
    rounding against the exact product (``rounding_row``)."""
    import torch
    from repro_torch.kernels import fp8_matmul as fm
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for label, M, K, N, types in shapes or (
            GEMM_SHAPES + SSM_GEMM_SHAPES + WIDE_GEMM_SHAPES):
        plan = plan_note(M, N, K, "gemm")
        print(f"[gemm] {label} M={M} K={K} N={N}: plan {plan}", flush=True)
        for kind in types:
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
            if label in ROUNDING_LABELS and kind == "bf16":
                # cuBLAS's bf16 GEMM runs on the same tensor cores: if it
                # leans as kernel A does, the lean is the hardware's
                stats = rounding_row(x, w, ("cublas_bf16", lambda a, b, **_:
                                            torch.matmul(a, b)))
                stats["cublas_bf16_reduced_precision_reduction"] = \
                    torch.backends.cuda.matmul.\
                    allow_bf16_reduced_precision_reduction
                lean = stats["kernel_a_f32_bias_to_zero"]
                print(f"[gemm] {label} K={K}: bf16 outputs off the exact "
                      f"product rounded to nearest: kernel A "
                      f"{100 * stats['flips']['kernel_a']:.3f}%, torch "
                      f"backend {100 * stats['flips']['torch']:.3f}%, "
                      f"cuBLAS bf16 {100 * stats['flips']['cublas_bf16']:.3f}%"
                      " (ROADMAP §3, rwkv6-3b's linears at K <= 8960: "
                      "0.153% and 0.024%); mean signed error toward zero "
                      "over the exact RMS, f32 sums: kernel A "
                      f"{lean:.2e} (limit {ROUNDING_LEAN_LIMIT:.0e}), torch "
                      f"{stats['torch_f32_bias_to_zero']:.2e} (-2.0e-6 "
                      "there); bf16 outputs: kernel A "
                      f"{stats['bf16_bias_to_zero']['kernel_a']:.2e}, cuBLAS "
                      f"{stats['bf16_bias_to_zero']['cublas_bf16']:.2e} "
                      f"{json.dumps(stats)}", flush=True)
                if not abs(lean) <= ROUNDING_LEAN_LIMIT:
                    fail(f"GEMM {label}: kernel A's f32 sums lean {lean:.2e}"
                         f" of the exact RMS toward zero, past "
                         f"{ROUNDING_LEAN_LIMIT:.0e}")
            # times at the output type the main path uses there
            out_dtype = torch.float32 if (label.endswith("head")
                                          or kind != "bf16") \
                else torch.bfloat16
            ebytes = 2 if kind == "bf16" else 1
            obytes = 4 if out_dtype == torch.float32 else 2
            err = (fm.fp8_matmul(x, w, out_dtype).float()
                   - fm.fp8_matmul_plain(x, w, out_dtype).float()
                   ).abs().max().item()
            iters = 20 if N > 20000 else 50
            ms, copies, timer = cold_ms(
                lambda a, b: fm.fp8_matmul(a, b, out_dtype), (x, w), iters)
            plain = time_ms(lambda: fm.fp8_matmul_plain(x, w, out_dtype), 5)
            lib, lib_note, lib_timer = None, None, None
            if kind == "bf16":
                lib, _, lib_timer = cold_ms(torch.matmul, (x, w), iters)
            elif kind == "e4m3":
                lib, lib_note, lib_timer = scaled_mm_ms(x, w, out_dtype,
                                                       iters)
            else:
                lib_note = "torch._scaled_mm has no e5m2 x e5m2 form"
            bms, by = bound_ms(M * K * ebytes + K * N * ebytes
                               + M * N * obytes, 2.0 * M * N * K, kind)
            row = {"label": label, "M": M, "K": K, "N": N, "type": kind,
                   "out": str(out_dtype).split(".")[-1], "max_abs_err": err,
                   "ms": ms, "plain_ms": plain, "library_ms": lib,
                   "timer": timer, "library_timer": lib_timer,
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
    Returns (ms, note, timer) as ``cold_ms`` gives them."""
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
        ms, _, timer = cold_ms(lambda a, b: torch._scaled_mm(
            a, b, scale_a=one, scale_b=one, out_dtype=out_dtype),
            (xp, wc), iters)
    except (RuntimeError, TypeError) as e:
        return (None, f"torch._scaled_mm raised: {str(e).splitlines()[0]}",
                None)
    return ms, note, timer


# ---------------------------------------------------------------------------
# Kernel A, expert-batched: a MoE layer's per-expert GEMMs in one launch
# ---------------------------------------------------------------------------

# (label, E, M, K, N, types): granite-moe-3b-a800m's expert gate/up (d
# 1536 -> expert d_ff 512) and down GEMMs at a 4-slot decode step
# (capacity M = ceil(4 * 8 * 1.25 / 40) = 1 per expert) and at a 128-token
# prefill (capacity 32), in the two types [moe] serves; llama4-scout's (d
# 5120 -> expert d_ff 8192, 16 experts, top 1) at decode (capacity
# ceil(4 * 1.25 / 16) = 1) and at a 128-token prefill (ceil(128 * 1.25 /
# 16) = 10), in bf16, the type [moe-top1] serves
EXPERT_TYPES = ("bf16", "e4m3")
EXPERT_SHAPES = (
    ("moe_decode_gate_up", 40, 1, 1536, 512, EXPERT_TYPES),
    ("moe_decode_down", 40, 1, 512, 1536, EXPERT_TYPES),
    ("moe_prefill_gate_up", 40, 32, 1536, 512, EXPERT_TYPES),
    ("moe_prefill_down", 40, 32, 512, 1536, EXPERT_TYPES),
    ("top1_decode_gate_up", 16, 1, 5120, 8192, ("bf16",)),
    ("top1_decode_down", 16, 1, 8192, 5120, ("bf16",)),
    ("top1_prefill_gate_up", 16, 10, 5120, 8192, ("bf16",)),
    ("top1_prefill_down", 16, 10, 8192, 5120, ("bf16",)),
)


def expert_gemm_phase():
    """Kernel A's expert-batched entry (``fp8_matmul_batched``) at the
    [moe] and [moe-top1] phases' shapes, bf16 -> bf16 and e4m3 -> f32 as the
    main path runs it, with a quarter of the experts given no token (zero
    rows): against its plain twin (the per-expert loop of the plain GEMM) under
    GEMM_REL_TOL, exact zeros for the empty experts, a bit-equal repeat, one
    launch per call; timed with its bound (every expert's weight read once) and
    ``torch.bmm`` on the same bf16 operands (no batched library call takes
    e4m3)."""
    import torch
    from repro_torch.kernels import fp8_matmul as fm
    if not hasattr(fm, "fp8_matmul_batched"):
        print("[experts] this checkout has no expert-batched GEMM; skipped",
              flush=True)
        return []
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows = []
    for label, E, M, K, N, types in EXPERT_SHAPES:
        plan = plan_note(M, N, K, "gemm", E)
        for kind in types:
            x = torch.randn((E, M, K), generator=gen, device="cuda")
            x[::4] = 0                               # experts with no token
            w = torch.randn((E, K, N), generator=gen, device="cuda") \
                * K ** -0.5
            if kind == "bf16":
                x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
                out_dtype, ebytes, obytes = torch.bfloat16, 2, 2
            else:
                from repro_torch.core import fp8 as fp8lib
                x = fp8lib.quantize_stack(x)[0]
                w = fp8lib.quantize_stack(w)[0]
                out_dtype, ebytes, obytes = torch.float32, 1, 4
            before = fm.LAUNCHES
            got = fm.fp8_matmul_batched(x, w, out_dtype)
            launched = fm.LAUNCHES - before
            again = fm.fp8_matmul_batched(x, w, out_dtype)
            want = fm.fp8_matmul_batched_plain(x, w, out_dtype)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            rel = err / max(want.float().abs().max().item(), 1e-30)
            name = str(out_dtype).split(".")[-1]
            same = bit_equal(got, again)
            empty = bool((got[::4] == 0).all())
            ok = bool(torch.isfinite(got).all()) and launched == 1 and \
                rel <= GEMM_REL_TOL[name] and same and empty
            print(f"[experts] {label} E={E} M={M} K={K} N={N} {kind}->"
                  f"{name}: max_abs_err={err:.3e} rel={rel:.2e} launches "
                  f"per call {launched}, empty experts zero={empty}, repeat "
                  f"bit-equal={same}, plan {plan} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"expert GEMM {label} {kind} disagrees with its plain "
                     f"version (rel {rel:.2e}), with itself ({same}), "
                     f"launched {launched} times or left an empty expert "
                     f"non-zero ({empty})")
            ms, copies, timer = cold_ms(
                lambda a, b: fm.fp8_matmul_batched(a, b, out_dtype), (x, w),
                50)
            plain = time_ms(
                lambda: fm.fp8_matmul_batched_plain(x, w, out_dtype), 5)
            lib, lib_note, lib_timer = None, "no batched library GEMM " \
                "takes e4m3", None
            if kind == "bf16":
                lib, _, lib_timer = cold_ms(torch.bmm, (x, w), 50)
                lib_note = "torch.bmm"
            bms, by = bound_ms(E * (M * K + K * N) * ebytes
                               + E * M * N * obytes, 2.0 * E * M * N * K,
                               kind)
            row = {"label": label, "E": E, "M": M, "K": K, "N": N,
                   "type": kind, "out": name, "max_abs_err": err,
                   "ms": ms, "plain_ms": plain, "library_ms": lib,
                   "timer": timer, "library_timer": lib_timer,
                   "library_note": lib_note, "bound_ms": bms,
                   "bound_by": by, "plan": plan, "operand_copies": copies}
            rows.append(row)
            print(f"[experts-time] {json.dumps(row)}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# Kernel B: flash attention against its plain version
# ---------------------------------------------------------------------------

# B, h, kvh, S, hd: llama3-8b's prefills, gemma3-12b's global layers
# (head_dim 256) at a 128-token prompt and at the [local] phase's long one,
# zamba2-1.2b's shared attention (32 heads of 64, group 1) at a 128-token
# prompt and at the [hybrid] phase's long one, llama4-scout's prefills
# (40 query heads over 8 kv heads: group 5), and [dense-wide]'s:
# chameleon-34b's and deepseek-67b's (64 over 8: group 8) and
# llama3-405b's (128 over 8: group 16)
WIDE_FLASH_SHAPES = ((1, 64, 8, 128, 128), (1, 64, 8, 77, 128),
                     (1, 128, 8, 128, 128), (1, 128, 8, 77, 128))
FLASH_SHAPES = ((1, 32, 8, 128, 128), (1, 32, 8, 77, 128),
                (1, 16, 8, 128, 256), (1, 16, 8, 1040, 256),
                (1, 32, 32, 128, 64), (1, 32, 32, 512, 64),
                (1, 40, 8, 128, 128), (1, 40, 8, 77, 128)) \
    + WIDE_FLASH_SHAPES
# kernel-vs-plain tolerance (absolute, on bf16 outputs of magnitude <= ~3):
# f32 online softmax against a full softmax, then one bf16 rounding.
FLASH_TOL = 2e-2


def flash_flops(B, h, S, hd):
    """Multiply-adds of QK^T and PV over the causal lower triangle."""
    return 4.0 * hd * B * h * S * (S + 1) / 2


def flash_plan_note(B, h, S, hd) -> str:
    """Kernel B's grid at this shape, or a note where the checkout under
    test does not describe it."""
    from repro_torch.kernels import flash_attention as fa
    if not hasattr(fa, "describe_grid"):
        return "no grid description in this checkout"
    return fa.describe_grid(B, h, S, hd) if hd != 128 \
        else fa.describe_grid(B, h, S)


def flash_phase(shapes=FLASH_SHAPES):
    """Kernel B at the prefill ``shapes``: checked against its plain
    version and for a bit-equal repeat, then timed beside SDPA by device
    time with the operands out of L2 (CUDA-event means as a second
    column)."""
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
    for B, h, kvh, S, hd in shapes:
        if hd not in fa.HEAD_DIMS:
            print(f"[flash] hd={hd}: not a head dim of this checkout's "
                  "kernel; skipped", flush=True)
            continue
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
        plan = flash_plan_note(B, h, S, hd)
        print(f"[flash] B={B} h={h} kvh={kvh} S={S} hd={hd} causal: "
              f"max_abs_err={err:.3e} repeat bit-equal={same} plan {plan} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"flash attention S={S} disagrees with its plain version "
                 f"(max_abs_err {err:.3e} > {FLASH_TOL}) or with itself "
                 f"(bit-equal {same})")
        ms, copies, timer = cold_ms(kernel, (q, k, v), 100)
        lib, _, lib_timer = cold_ms(sdpa, (q, k, v), 100)
        plain = time_ms(
            lambda: fa.flash_attention_plain(q, k, v, causal=True), 20)
        n_bytes = 2 * (2 * B * h * S * hd + 2 * B * kvh * S * hd)
        bms, by = bound_ms(n_bytes, flash_flops(B, h, S, hd), "bf16")
        label = f"prefill_S{S}" + (f"_hd{hd}" if hd != 128 else "") \
            + (f"_h{h}" if hd == 128 and h != 32 else "")
        row = {"label": label, "B": B, "h": h, "kvh": kvh, "S": S,
               "hd": hd, "max_abs_err": err, "ms": ms,
               "event_ms": time_ms(lambda: kernel(q, k, v), 100),
               "plain_ms": plain, "library_ms": lib,
               "timer": timer, "library_timer": lib_timer,
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
# and the ragged 77), a shape ragged in N and K, and zamba2-1.2b's w_B /
# w_C / w_dt (N = 64) at decode and at its 512-token prefill.
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
    ("zamba2_decode_n64", 4, 2048, 64),
    ("zamba2_prefill_n64", 512, 2048, 64),
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
            ms, copies, timer = cold_ms(
                lambda a, v, m: sm.sparse24_matmul(a, v, m, out_dtype),
                (x, pw.values, pw.meta), iters)
            plain = time_ms(lambda: sm.sparse24_matmul_plain(
                x, pw.values, pw.meta, out_dtype), 5)
            w_dense = sp.unpack_24(pw.values, pw.meta).to(torch.bfloat16)
            lib, _, lib_timer = cold_ms(torch.matmul, (x, w_dense), iters)
            slib, snote, serr = semi_structured_ms(w_dense, x, iters)
            vbytes = pw.values.element_size()
            n_bytes = M * K * 2 + (K // 2) * N * vbytes + (K // 8) * N \
                + M * N * 2
            # the multiplies this data needs: the kept half of the weight
            bms, by = bound_ms(n_bytes, 2.0 * M * N * (K // 2), "bf16")
            row = {"label": label, "M": M, "K": K, "N": N, "values": kind,
                   "out": "bfloat16", "max_abs_err": err, "ms": ms,
                   "plain_ms": plain, "library_ms": lib,
                   "timer": timer, "library_timer": lib_timer,
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
        ms, copies, timer = cold_ms(
            lambda a, b: sm.block24_matmul(a, b, kept, block, out_dtype),
            (x, packed), 50)
        plain = time_ms(lambda: sm.block24_matmul_plain(
            x, packed, kept, block, out_dtype), 5)
        cols = torch.cat([torch.arange(i * block, (i + 1) * block,
                                       device="cuda") for i in kept])
        xk = x[:, cols].contiguous()
        lib, _, lib_timer = cold_ms(torch.matmul, (xk, packed), 50)
        n_bytes = M * (K // 2) * 2 + (K // 2) * N * 2 + M * N * 2
        bms, by = bound_ms(n_bytes, 2.0 * M * N * (K // 2), "bf16")
        row = {"label": f"M{M}_block{block}", "M": M, "K": K, "N": N,
               "block": block, "out": "bfloat16", "max_abs_err": err,
               "ms": ms, "plain_ms": plain, "library_ms": lib,
               "timer": timer, "library_timer": lib_timer,
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
        ms, copies, timer = cold_ms(pa.paged_flash_decode,
                                    (q, kp, vp, pm, ln), 100)
        sdpa_args = sdpa_operands(q, kp, vp, pm, ln)
        lib, _, lib_timer = cold_ms(sdpa_masked, sdpa_args, 100)
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
               "timer": timer, "library_timer": lib_timer,
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
# [profile]: the paper's characterization and calibration on the card
# ---------------------------------------------------------------------------

# Kernel A's occupancy curve: M = tiles x 128 at K = 4096, N = 1024, so 8
# to 1,024 grid tiles of 128 x 128 (a fill of 0.06-7.8 on 132 SMs). A's
# e4m3 path has no native fp8 wgmma (csrc/gemm.cu), so fp8 may never reach
# bf16 on it; calibrate then takes its "never won" branch, a finding.
PROFILE_TILES = (1, 2, 4, 8, 16, 32, 64, 128)
PROFILE_K, PROFILE_N = 4096, 1024
PROFILE_PRECISIONS = ("bf16", "fp8")
# the latency probe's chain and tile shapes (the reference's defaults) and
# the A/A sweep's shapes (block_sweep_probe's defaults)
PROFILE_CHAIN = 16
LATENCY_SHAPES = ((128, 128, 128), (256, 256, 128), (128, 128, 256),
                  (256, 256, 256), (512, 512, 128))
AA_SHAPES = ((256, 256, 256), (128, 256, 512))
# _time_fn's device time against torch.profiler's kernel time, at the two
# largest points of each precision
TIMER_TOL = 0.10
# contention_sweep's one-stream dilation (both times on the lane clock):
# the median of CONTENTION_REPEATS sweeps, after one untimed sweep that
# takes the first-use costs, must lie within this factor of 1; the
# isolated time is the mean of CONTENTION_ITERS calls
CONTENTION_STREAMS = (1, 2, 4)
CONTENTION_REPEATS = 3
CONTENTION_ITERS = 10
DILATION_FACTOR = 2.0
PROFILE_OUT = ROOT / "build" / "profile"


def profiled_time_fn(fn, a, b, iters: int):
    """``(timer_ms, profiler_ms)`` of one ``_time_fn`` call: its device
    time per call, and torch.profiler's summed kernel time per call of the
    calls it timed (those after its last sleep kernel). ``profiler_ms`` is
    None when every profile lost records."""
    from repro_torch.core import characterization as ch
    got = {}

    def run():
        got["s"] = ch._time_fn(fn, a, b, iters=iters)

    def after_sleep(kernels):
        sleeps = [e for e in kernels if "spin_kernel" in e.name]
        if not sleeps:
            if kernels:
                print("[profile] no sleep kernel among "
                      f"{sorted({e.name for e in kernels})}", flush=True)
            return []
        t = max(e.start for e in sleeps)
        return [e for e in kernels if e.start > t
                and "spin_kernel" not in e.name]

    def complete(kernels):
        timed = after_sleep(kernels)
        return bool(timed) and len(timed) % iters == 0

    traced_ = traced(run, complete, f"_time_fn over {iters} calls")
    if traced_ is None:
        return 1e3 * got["s"], None
    prof_us = sum(e.end - e.start for e in after_sleep(traced_[1]))
    return 1e3 * got["s"], prof_us / 1e3 / iters


def profile_sweep(prec, a_launches):
    """Kernel A's occupancy sweep and latency probe in one precision under
    ``hopper``, with A's launches held to the timed calls. Returns the
    records."""
    import torch
    from repro_torch.core import characterization as ch
    from repro_torch.kernels import fp8_matmul as fm
    kind = {"bf16": "bf16", "fp8": "e4m3"}[prec]
    out = []
    for name, per_call, kw in (
            ("occupancy_sweep", 1, dict(
                tile_counts=PROFILE_TILES, tile_m=128, k=PROFILE_K,
                n=PROFILE_N)),
            ("latency_probe", PROFILE_CHAIN, dict(
                tile_shapes=LATENCY_SHAPES, chain=PROFILE_CHAIN))):
        calls0, n0, t0 = ch.CALLS, fm.LAUNCHES, fm.TYPE_LAUNCHES[kind]
        recs = getattr(ch, name)(precisions=(prec,), device="cuda", **kw)
        torch.cuda.synchronize()
        calls = ch.CALLS - calls0
        got = (fm.LAUNCHES - n0, fm.TYPE_LAUNCHES[kind] - t0)
        print(f"[profile] {name} {prec}: {len(recs)} points, {calls} timed "
              f"calls, kernel A launches {got[0]} ({kind} {got[1]}), "
              f"expected {per_call * calls}", flush=True)
        if got != (per_call * calls, per_call * calls):
            fail(f"[profile] {name} {prec}: kernel A launched {got} times "
                 f"for {calls} calls of {per_call} GEMMs")
        a_launches[0] += got[0]
        out += recs
    return out


def yardstick(prec, a, b):
    """The library's own call on a sweep point's operands: ``torch.matmul``
    in bf16, ``torch._scaled_mm`` in e4m3 (f32 out, unit scales, B made
    column-major untimed). Device ms per call by _time_fn, L2-warm as the
    sweep's points."""
    import torch
    from repro_torch.core import characterization as ch
    if prec == "bf16":
        return "torch.matmul", ch._time_fn(torch.matmul, a, b) * 1e3
    one = torch.ones((), device=a.device)
    wc = b.t().contiguous().t()
    return "torch._scaled_mm", ch._time_fn(lambda x, w: torch._scaled_mm(
        x, w, scale_a=one, scale_b=one, out_dtype=torch.float32), a, wc) * 1e3


def plain_check(label, a, b):
    """The sweep's GEMM (``_matmul_fn``: ``raw_matmul`` through the default
    backend's registry entry to kernel A) against its plain version on the
    same operands, f32 out, within GEMM_REL_TOL. Returns (rel, kernel A
    launches made), which count for no path."""
    from repro_torch.core import characterization as ch
    from repro_torch.kernels import fp8_matmul as fm
    n0 = fm.LAUNCHES
    got = ch._matmul_fn(a.dtype)(a, b)
    launches = fm.LAUNCHES - n0
    want = fm.fp8_matmul_plain(a, b)
    err = (got - want).abs().max().item()
    rel = err / max(want.abs().max().item(), 1e-30)
    ok = got.shape == want.shape and rel <= GEMM_REL_TOL["float32"] \
        and launches == 1
    print(f"[profile-check] {label} {tuple(a.shape)}x{tuple(b.shape)} "
          f"{a.dtype}: rel {rel:.2e}, {launches} launch of A "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"[profile] {label}: kernel A through raw_matmul disagrees "
             f"with its plain version (rel {rel:.2e}) or launched "
             f"{launches} times")
    return rel, launches


def occupancy_rows(occ_records):
    """Each occupancy point beside kernel A's plan and the library's time
    on the same operands (regenerated from the sweep's seed), each point's
    output held against its plain version, and the timer cross-check at
    the two largest points of each precision. Returns (rows, timer checks,
    kernel A launches of the plain checks)."""
    import torch
    from repro_torch.core import characterization as ch
    rows, checks, check_launches = [], [], 0
    for prec in PROFILE_PRECISIONS:
        dtype = ch.PRECISIONS[prec]
        gen = torch.Generator(device="cuda").manual_seed(0)
        recs = {r.derived["tiles"]: r for r in occ_records
                if r.derived["precision"] == prec}
        for t in PROFILE_TILES:
            m = t * 128
            a = ch._mk((m, PROFILE_K), dtype, gen)
            b = ch._mk((PROFILE_K, PROFILE_N), dtype, gen)
            rec = recs[t]
            flops = 2.0 * m * PROFILE_K * PROFILE_N
            rel, n = plain_check(f"occupancy {prec} tiles={t}", a, b)
            check_launches += n
            lib, warm = yardstick(prec, a, b)
            row = {"precision": prec, "tiles": t, "grid_tiles":
                   t * PROFILE_N // 128, "M": m, "K": PROFILE_K,
                   "N": PROFILE_N, "ms": rec.us_per_call / 1e3,
                   "tflops": rec.derived["gflops"] / 1e3,
                   "norm_to_best": rec.derived["norm_to_best"],
                   "plan": plan_note(m, PROFILE_N, PROFILE_K, "gemm"),
                   "library": lib, "library_ms": warm,
                   "library_tflops": flops / warm / 1e9,
                   "plain_rel_err": rel}
            if t in PROFILE_TILES[-2:]:
                timer_ms, prof_ms = profiled_time_fn(
                    ch._matmul_fn(dtype), a, b, 5)
                row["timer_check"] = {"time_fn_ms": timer_ms,
                                      "profiler_ms": prof_ms}
                checks.append((prec, t, timer_ms, prof_ms))
            rows.append(row)
            print(f"[profile-occ] {json.dumps(row)}", flush=True)
            del a, b
    return rows, checks, check_launches


def latency_checks():
    """Each latency-probe shape's GEMM, as the chain's first link runs it,
    against its plain version in both precisions. Returns kernel A's
    launches."""
    import torch
    from repro_torch.core import characterization as ch
    launches = 0
    for prec in PROFILE_PRECISIONS:
        gen = torch.Generator(device="cuda").manual_seed(0)
        for m, n, k in LATENCY_SHAPES:
            a = ch._mk((m, k), ch.PRECISIONS[prec], gen)
            b = ch._mk((k, max(n, k)), ch.PRECISIONS[prec], gen)
            launches += plain_check(f"latency {prec} {m}x{n}x{k}", a, b)[1]
    return launches


def contention_check():
    """contention_sweep on the card under the ``torch`` backend (its
    operands are f32): both of its times read the lane clock, so one
    stream's dilation, the median of CONTENTION_REPEATS sweeps, must lie
    within DILATION_FACTOR of 1. Returns the medians by record name."""
    from repro_torch.core import characterization as ch
    runs = [ch.contention_sweep(stream_counts=CONTENTION_STREAMS,
                                iters=CONTENTION_ITERS, device="cuda",
                                seed=i)
            for i in range(CONTENTION_REPEATS + 1)][1:]
    med = {}
    for recs in zip(*runs):
        d = sorted(r.derived["dilation"] for r in recs)
        med[recs[0].name] = d[len(d) // 2]
        print(f"[profile-contention] {recs[0].name}: dilation {d} "
              f"(median {med[recs[0].name]}), us per stream "
              f"{[round(r.us_per_call, 2) for r in recs]}", flush=True)
    for name, d in med.items():
        if name.endswith("/streams=1") and not (
                1 / DILATION_FACTOR <= d <= DILATION_FACTOR):
            fail(f"[profile] {name}: one stream reads a dilation of {d}, "
                 f"not within {DILATION_FACTOR}x of 1")
    return med


def profile_phase(smi, sweep_records):
    """The paper's characterization on the card: the profile CLI under the
    default ``torch`` backend and under ``hopper``; kernel A's occupancy
    curve and tile latency under ``hopper`` (bf16, e4m3), held against the
    plain version and beside the library's; the timer against
    torch.profiler; the one-stream contention dilation; the autotune store
    fed, calibrated, saved and installed; the block sweep as an A/A test.
    Returns kernel A's launches, the plain checks' left out."""
    import torch
    from repro_torch.core import autotune, characterization as ch
    from repro_torch.core import concurrency as cc, execution as ex
    from repro_torch.kernels import fp8_matmul as fm
    from repro_torch.launch import profile
    print(f"[profile] {smi}: characterization and calibration on the card",
          flush=True)
    t_phase = time.perf_counter()
    saved_cache = dict(ex.BLOCK_CACHE._best)
    a_launches = [0]

    # the CLI, as a user runs it (default backend: torch)
    prev = ex.default_backend()
    n0 = fm.LAUNCHES
    cli_dir = PROFILE_OUT / "cli"
    if profile.main(["--quick", "--reset", "--artifact-dir", str(cli_dir),
                     "--device", "cuda"]) != 0:
        fail("[profile] launch/profile.py --quick returned non-zero")
    if not autotune.AutotuneStore(str(cli_dir)).load():
        fail(f"[profile] the CLI wrote no loadable artifact in {cli_dir}")
    if fm.LAUNCHES != n0:
        fail("[profile] the torch backend's CLI run launched kernel A")
    print(f"[profile] CLI artifact reloads: {cli_dir / 'autotune.json'}",
          flush=True)
    # the CLI calibrating kernel A, as a user does for `--autotune` under
    # hopper; the backend is restored and named in the artifact
    n0, hop_dir = fm.LAUNCHES, PROFILE_OUT / "cli_hopper"
    if profile.main(["--quick", "--reset", "--artifact-dir", str(hop_dir),
                     "--device", "cuda", "--backend", "hopper"]) != 0:
        fail("[profile] launch/profile.py --quick --backend hopper returned "
             "non-zero")
    cli_launches = fm.LAUNCHES - n0
    a_launches[0] += cli_launches
    cli = autotune.AutotuneStore(str(hop_dir))
    cli.load()
    print(f"[profile] CLI --backend hopper: kernel A launches "
          f"{cli_launches}, artifact backend {cli.thresholds.get('backend')}"
          f", default backend after {ex.default_backend()}", flush=True)
    if not cli_launches or cli.thresholds.get("backend") != "hopper" \
            or cli.backends() != {"hopper"} or ex.default_backend() != prev:
        fail("[profile] the CLI's hopper calibration did not run on kernel A,"
             " name its backend, or restore the default backend")

    # kernel A's curves under hopper
    ex.set_default_backend("hopper")
    try:
        recs = []
        for prec in PROFILE_PRECISIONS:
            recs += profile_sweep(prec, a_launches)
        occ = [r for r in recs if r.name.startswith("occupancy/")]
        lat = [r for r in recs if r.name.startswith("latency/")]
        n0 = fm.LAUNCHES
        rows, checks, n_chk = occupancy_rows(occ)
        a_launches[0] += fm.LAUNCHES - n0 - n_chk
        latency_checks()
        for r in lat:
            print(f"[profile-lat] {r.name}: {r.derived['per_tile_us']} us "
                  f"per link (plan {plan_note(*_mnk(r), 'gemm')})",
                  flush=True)
    finally:
        ex.set_default_backend(prev)
    contention = contention_check()
    for prec, t, timer_ms, prof_ms in checks:
        if prof_ms is None:
            print(f"[profile] timer check {prec} tiles={t}: torch.profiler "
                  "recorded no kernels in any attempt, so the cross-check "
                  "could not run (a known burst fault, PERF.md §7); the "
                  "sleep gate held", flush=True)
            continue
        rel = abs(timer_ms - prof_ms) / prof_ms
        print(f"[profile] timer check {prec} tiles={t}: _time_fn "
              f"{timer_ms:.5f} ms, profiler {prof_ms:.5f} ms, rel "
              f"{rel:.4f} (tol {TIMER_TOL})", flush=True)
        if rel > TIMER_TOL:
            fail(f"[profile] _time_fn is {rel:.3f} off torch.profiler at "
                 f"{prec} tiles={t}")

    # the store: hopper evidence and [sweep]'s page geometries
    n_cores = cc.detect_core_count()
    store = autotune.AutotuneStore(str(PROFILE_OUT / "hopper"))
    store.reset()
    n_in = store.add_records(list(recs) + list(sweep_records),
                             backend="hopper")
    hd = PAGED_GEOMETRY["hd"]
    best = min(sweep_records, key=lambda r: r.us_per_call)
    entry = store.blocks.get((SLOTS, hd, MAX_LEN, "bf16"))
    want = (1, best.derived["page_size"], hd)
    print(f"[profile] store: {n_in} records ingested, {len(store.samples)} "
          f"samples, {len(store.blocks)} block entries; pagedsweep entry "
          f"{entry}", flush=True)
    if entry is None or entry[0] != want:
        fail(f"[profile] the store holds {entry} for [sweep]'s shape, not "
             f"{want}")
    thr = store.calibrate(n_cores=n_cores)
    th90 = ch.occupancy_threshold(occ, 0.9)
    won = fp8_won(store)
    print(f"[profile] n_cores={n_cores}; tiles to 90% of best: "
          + ", ".join(f"{p}={t}" for p, t in sorted(th90.items()))
          + "; fp8 reaches bf16 at grid tiles " + (
              f"{won} -> knee {thr['knee_tiles']:g} tiles, demote below "
              f"fill {thr['demote_below_fill']:.4g}" if won else
              "none (never won): calibrate demotes fp8 wherever it has "
              f"evidence, up to {thr.get('knee_tiles', 0):g} tiles, fill "
              f"{thr.get('demote_below_fill', 0):.4g}"), flush=True)
    if thr.get("backend") != "hopper":
        fail(f"[profile] the calibration names backend "
             f"{thr.get('backend')}, not hopper")
    for line in profile.resolve_lines(store, thr, n_cores, "hopper"):
        print(f"[profile] {line.strip()}", flush=True)
    path = store.save()
    autotune.install(store)
    try:
        calibrated = ex.get_default_advisor().calibrated
        print(f"[profile] saved {path}; installed: advisor calibrated="
              f"{calibrated}", flush=True)
        if calibrated != ("demote_below_fill" in thr):
            fail("[profile] install() left the advisor's calibration "
                 f"{calibrated}, thresholds {thr}")
    finally:
        ex.set_default_advisor(None)

    # the block sweep under hopper: an A/A test of the timer
    n0, calls0 = fm.LAUNCHES, ch.CALLS
    blocks = ch.block_sweep_probe(shapes=AA_SHAPES,
                                  precisions=PROFILE_PRECISIONS,
                                  backend="hopper", device="cuda")
    torch.cuda.synchronize()
    if fm.LAUNCHES - n0 != ch.CALLS - calls0:
        fail(f"[profile] block sweep: {fm.LAUNCHES - n0} launches of A for "
             f"{ch.CALLS - calls0} calls")
    aa_rows = aa_check(blocks)
    a_launches[0] += fm.LAUNCHES - n0
    autotune.dump_records(recs + blocks, str(PROFILE_OUT / "records.json"))
    ex.BLOCK_CACHE._best.clear()
    ex.BLOCK_CACHE._best.update(saved_cache)
    summary = {"nvidia_smi": smi, "occupancy": rows, "thresholds": thr,
               "tiles_to_90": th90, "fp8_won_at": won, "aa": aa_rows,
               "latency_us": {r.name: r.derived["per_tile_us"]
                              for r in lat},
               "contention_dilation": contention,
               "kernel_a_launches": a_launches[0],
               "seconds": time.perf_counter() - t_phase}
    print(f"[profile-summary] {json.dumps(summary)}", flush=True)
    print(f"[profile] {summary['seconds']:.1f}s, kernel A launches "
          f"{a_launches[0]}", flush=True)
    return a_launches[0]


def _mnk(rec):
    m, n, k = (int(v) for v in rec.derived["tile"].split("x"))
    return m, max(n, k), k


def fp8_won(store):
    """The grid-tile buckets where mean fp8 throughput reached bf16's."""
    by = {}
    for s in store.samples:
        by.setdefault((s.precision, s.tiles), []).append(s.gflops)
    mean = {k: sum(v) / len(v) for k, v in by.items()}
    return sorted(t for (p, t) in mean if p == "fp8" and ("bf16", t) in mean
                  and mean["fp8", t] >= mean["bf16", t])


def aa_check(records):
    """Each block-sweep group's candidate tilings, run again on one pair of
    operands: bit-equal outputs, and the spread of their times."""
    import torch
    from repro_torch.core import execution as ex
    groups = {}
    for r in records:
        groups.setdefault(r.name.rsplit("/", 1)[0], []).append(r)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for key, grp in groups.items():
        d = grp[0].derived
        x = torch.randn((d["m"], d["k"]), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = torch.randn((d["k"], d["n"]), generator=gen, device="cuda").to(
            torch.bfloat16)
        outs = []
        for r in grp:
            bm, bn, bk = (int(v) for v in r.derived["blocks"].split("x"))
            pol = ex.ExecutionPolicy(precision=d["precision"],
                                     backend="hopper", block_m=bm,
                                     block_n=bn, block_k=bk)
            outs.append(ex.matmul(x, w, pol, out_dtype=torch.float32))
        same = all(bit_equal(o, outs[0]) for o in outs[1:])
        us = [r.us_per_call for r in grp]
        row = {"group": key, "tilings": [r.derived["blocks"] for r in grp],
               "us": us, "spread": (max(us) - min(us)) / min(us),
               "bit_equal": same}
        rows.append(row)
        print(f"[profile-aa] {json.dumps(row)}", flush=True)
        if not same:
            fail(f"[profile] {key}: candidate tilings gave different bits "
                 "under hopper (the plan must not read the blocks)")
    return rows


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
        sm.BLOCK24_LAUNCHES = fm.BATCHED_LAUNCHES = 0
    fm.TYPE_LAUNCHES.update(dict.fromkeys(fm.TYPE_LAUNCHES, 0))
    fm.WIDTH_LAUNCHES.clear()


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


def perturbed(sess, logits):
    """The logits a sampled session's latest draw ranked: ``logits / T``
    plus the Gumbel noise of its key (``sess.last_key``) over their whole
    shape; a greedy session's logits as they are."""
    from repro_torch.core import prng
    if not sess.temperature > 0:
        return logits
    return logits.float() / sess.temperature + prng.gumbel(
        sess.last_key, logits.shape, logits.device)


def drive(sess, requests, twin=None, after_first_decode=None, teacher=None):
    """Serve ``requests`` the way ``ServeSession.run`` does, one admission
    and one decode step at a time, timing each (host clock around work
    that ends in a device synchronise) and keeping what the comparison
    needs: the first prefill's and first decode's logits, and the top-2
    margin behind every token (of the perturbed logits, ``perturbed``,
    when the session samples). ``twin(params, tokens, caches, pos)`` is
    run on a copy of the state the first decode step starts from, so its
    logits compare with that step's on identical inputs;
    ``after_first_decode(sess)`` is called once, after that step.
    ``teacher = (prefill_twin(params, prompt), step_twin(params, tokens,
    caches, pos))`` returns the logits of another backend on the inputs of
    every admission and every decode step (a copy of the state, out of
    the timed region): per token, ``run["teacher"]`` keeps the session's
    token, the argmax of the teacher's perturbed logits under the same
    draw, and their top-2 margin."""
    import numpy as np
    import torch
    for r in requests:
        sess.submit(r)
    first = {}
    margins = {}
    taught = []
    prefill_s, decode_s = [], []
    t_start = time.perf_counter()

    def teach(uid, n, tok, row):
        taught.append((uid, n, tok, int(torch.argmax(row)), _margin(row)))

    while sess.queue or sess.n_active:
        while sess.queue and sess.can_admit(sess.queue[0]):
            req = sess.queue.pop(0)
            t0 = time.perf_counter()
            sess.admit(req)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
            first.setdefault("prefill", sess.last_logits[0].float().clone())
            margins[(req.uid, 0)] = _margin(perturbed(sess,
                                                      sess.last_logits[0]))
            if teacher is not None:
                prompt = torch.as_tensor(req.prompt.astype(np.int64),
                                         device=sess.device)[None]
                teach(req.uid, 0, req.out[0], perturbed(
                    sess, teacher[0](sess.params, prompt)[0].float()))
        active = [(i, r, len(r.out)) for i, r in enumerate(sess.slots)
                  if r is not None]
        state = None
        if teacher is not None or (twin is not None
                                   and "decode" not in first):
            state = (sess.tokens.clone(),
                     [{k: v.clone() for k, v in c.items()}
                      for c in sess.caches],
                     torch.as_tensor(sess.slot_pos.astype(np.int64),
                                     device=sess.device))
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.decode_once()
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
        if "decode" not in first:
            first["decode"] = sess.last_logits.float().clone()
            first["decode_rows"] = [i for i, _, _ in active]
            if twin is not None:
                first["decode_twin"] = twin(sess.params, *state).float()
            if after_first_decode is not None:
                after_first_decode(sess)
        rows = perturbed(sess, sess.last_logits)
        for i, r, n in active:
            margins[(r.uid, n)] = _margin(rows[i])
        if teacher is not None:
            rows = perturbed(sess, teacher[1](sess.params, *state).float())
            for i, r, n in active:
                teach(r.uid, n, r.out[n], rows[i])
    wall = time.perf_counter() - t_start
    outs = {r.uid: list(r.out) for r in sess.completed}
    return {"outs": outs, "first": first, "margins": margins,
            "teacher": taught, "prefill_s": prefill_s, "decode_s": decode_s,
            "wall_s": wall}


def serve_against_torch(cfg, params, requests, precision, tag,
                        max_len=MAX_LEN, rt_kw=None):
    """``{precision}:dense:hopper`` served (``drive``) and held against a
    ``torch``-backend run of the same requests (``check_serve``; the
    first decode step's torch twin runs on a copy of the hopper run's
    state), then a profiled decode step. ``rt_kw`` goes to both sessions'
    ``RuntimeCfg``. A MoE stack's end-to-end comparison is printed, not
    gated (``check_serve``): under fp8, whose torch backend quantizes each
    expert's weight per call in a per-expert loop (2.9 s per decode step
    on granite-moe-3b-a800m, 111 s a run on the card), it is not served
    end to end on that backend; its first decode step is compared with the
    twin, and ``layerwise_check`` holds it. Returns (results, the hopper
    run, its launches, its expert-batched launches of kernel A)."""
    from repro_torch.core import execution as ex
    from repro_torch.kernels import fp8_matmul as fm
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.runtime.serve_loop import ServeSession, make_serve_step
    rt_kw = rt_kw or {}
    policy = f"{precision}:dense:hopper"

    def session(backend, use_pallas):
        return ServeSession(
            params, cfg, batch_slots=SLOTS, max_len=max_len,
            rt=RuntimeCfg(use_pallas=use_pallas, **rt_kw),
            policy=ex.parse_policy(f"{precision}:dense:{backend}"),
            device="cuda")

    torch_step = make_serve_step(
        cfg, RuntimeCfg(**rt_kw),
        policy=ex.parse_policy(f"{precision}:dense:torch"))

    def twin(p, tokens, caches, pos):
        return torch_step(p, tokens, caches, pos)[1]

    hop = session("hopper", True)
    zero_launch_counts()
    run = drive(hop, requests(), twin)
    launches, batched = launch_counts(), fm.BATCHED_LAUNCHES
    widths = dict(fm.WIDTH_LAUNCHES)
    del hop
    base = None if cfg.num_experts and precision != "bf16" else \
        drive(session("torch", False), requests())
    if launch_counts() != launches:
        fail(f"{tag}: the torch-backend session launched a port kernel")
    res = check_serve(tag, run, base, launches, cfg, policy)
    res["expert_batched_launches"] = batched
    res["gemm_launches_by_width"] = widths
    res.update(profile_decode(session("hopper", True), requests(),
                              res["decode_ms_per_step"]))
    return res, run, launches, batched


def serve_phase():
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.runtime.serve_loop import Request

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
        results[tag], run, launches, _ = serve_against_torch(
            cfg, params, requests, precision, tag)
        if precision == "bf16":
            results[PAGED_TAG] = serve_paged(params, cfg, requests, run,
                                             launches)
            greedy_outs = run["outs"]
    torch.cuda.empty_cache()
    results.update(serve_sample(params, cfg, requests,
                                results["bf16:dense:hopper"],
                                results[PAGED_TAG], greedy_outs))
    torch.cuda.empty_cache()
    if ARGS.sample_only:
        return results
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


SAMPLE_TAG = "bf16:dense:hopper sampled"
SAMPLE_PAGED_TAG = "bf16:dense:hopper sampled paged"
SAMPLE_TEMPERATURE = 0.7
# the card's Gumbel noise against the CPU's: torch.log's last bits
GUMBEL_TOL = 2e-6
# beside the decode step's (SLOTS, Vp): a shape of odd size and rank 3
SAMPLE_RAGGED = (3, 77, 999)
SAMPLER_CALLS = 20
SAMPLER_QUEUED = 4       # 4 x 183 launches: within the card's launch queue


def check_sampler_bits(keys, vp) -> dict:
    """``core/prng.py`` on the card against the CPU (held to ``jax.random``
    by the CPU tests) under the sampled session's first keys: bits and
    uniforms bit-equal, Gumbel noise within GUMBEL_TOL, at (SLOTS, Vp) and
    SAMPLE_RAGGED; the step's sampler (``serve_loop.next_tokens``) on
    seeded logits token-equal to the CPU's but at a near-tie (top-2
    margin under 1e-5), launching none of the port's kernels."""
    import numpy as np
    import torch
    from repro_torch.core import prng
    from repro_torch.runtime.serve_loop import next_tokens
    gap = 0.0
    for key in keys:
        for shape in ((SLOTS, vp), SAMPLE_RAGGED):
            for name, fn in (("random_bits", prng.random_bits),
                             ("uniform", prng.uniform)):
                card, cpu = fn(key, shape, device="cuda").cpu(), \
                    fn(key, shape, device="cpu")
                same = torch.equal(card, cpu) if name == "random_bits" \
                    else bit_equal(card, cpu)
                if not same:
                    fail(f"[sample] prng.{name}{shape} under key "
                         f"{key.tolist()} differs between the card and CPU")
            g = prng.gumbel(key, shape, device="cuda").cpu()
            gap = max(gap, float((g - prng.gumbel(key, shape, device="cpu"))
                                 .abs().max()))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    logits = torch.randn((SLOTS, vp), generator=gen, device="cuda")
    before = launch_counts()
    card = next_tokens(logits, SAMPLE_TEMPERATURE, keys[0])[:, 0].cpu()
    if launch_counts() != before:
        fail("[sample] the sampler launched a port kernel")
    cpu_logits = logits.cpu()
    cpu = next_tokens(cpu_logits, SAMPLE_TEMPERATURE, keys[0])[:, 0]
    inv = float(np.float32(1) / np.float32(SAMPLE_TEMPERATURE))
    rows = cpu_logits * inv + prng.gumbel(keys[0], (SLOTS, vp))
    ties = [i for i in range(SLOTS) if _margin(rows[i]) < 1e-5]
    flips = [i for i in range(SLOTS) if card[i] != cpu[i]]
    print(f"[sample] prng on the card under the session's first "
          f"{len(keys)} keys at {(SLOTS, vp)} and {SAMPLE_RAGGED}: "
          f"random_bits and uniform bit-equal to the CPU's; gumbel "
          f"max_abs_diff={gap:.3e} (tolerance {GUMBEL_TOL}); next_tokens "
          f"{card.tolist()} on the card, {cpu.tolist()} on the CPU "
          f"(near-ties in rows {ties}); no port kernel launched",
          flush=True)
    if gap > GUMBEL_TOL:
        fail(f"[sample] card gumbel {gap} from the CPU's, over {GUMBEL_TOL}")
    if set(flips) - set(ties):
        fail(f"[sample] the card's sampled tokens differ from the CPU's in "
             f"rows {flips} (near-ties {ties})")
    return {"gumbel_card_cpu_max_abs_diff": gap}


def profile_sampler(vp, key) -> dict:
    """Kernels and device ms per call of the step's token choice
    (``serve_loop.next_tokens``) at (SLOTS, Vp), sampled and greedy. The
    kernels are the host's launch calls (``cudaLaunchKernel``) in a
    torch.profiler trace of SAMPLER_CALLS calls; its device records,
    which the profiler now and then loses or adds one of in such a burst
    of small kernels, are kept beside them. The ms are device time behind
    a sleep (``characterization._device_s``) over SAMPLER_QUEUED calls,
    whose launches fit the card's launch queue; CUDA events over the calls
    (host gaps included) where the host could not get ahead, and the row
    says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.characterization import _device_s
    from repro_torch.runtime.serve_loop import next_tokens
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    logits = torch.randn((SLOTS, vp), generator=gen, device="cuda")
    out = {}
    for name, temp in (("sampler", SAMPLE_TEMPERATURE),
                       ("greedy_choice", 0.0)):
        args = (logits, temp, key)
        next_tokens(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(SAMPLER_CALLS):
                next_tokens(*args)
            torch.cuda.synchronize()
        launches = sum(a.count for a in prof.key_averages()
                       if a.key.startswith("cudaLaunchKernel"))
        out[f"{name}_kernels_per_step"] = launches / SAMPLER_CALLS
        out[f"{name}_device_records_per_step"] = \
            len(kernel_records(prof)) / SAMPLER_CALLS
        try:
            ms, timer = 1e3 * _device_s(next_tokens, args, SAMPLER_QUEUED,
                                        logits.device), "behind a sleep"
        except RuntimeError:
            ms, timer = time_ms(lambda: next_tokens(*args),
                                SAMPLER_CALLS), "cuda events"
        out[f"{name}_ms_per_step"], out[f"{name}_timer"] = ms, timer
    out["sampler_extra_kernels_per_step"] = \
        out["sampler_kernels_per_step"] - \
        out["greedy_choice_kernels_per_step"]
    return out


def serve_sample(params, cfg, requests, greedy, greedy_paged, greedy_outs):
    """``[sample]``: llama3-8b at full width under ``bf16:dense:hopper``,
    sampled at SAMPLE_TEMPERATURE from seed SEED, on ``[serve]``'s weights
    and requests. ``greedy`` and ``greedy_paged`` are the greedy dense and
    paged runs' results, ``greedy_outs`` the dense run's tokens. Gates:
    the prng on the card equals the CPU's (``check_sampler_bits``); at
    every admission and decode step the hopper session's token equals the
    argmax of the torch backend's logits, teacher forced on a copy of the
    same state, over T plus the step's own Gumbel draw, unless their top-2
    margin is under LOGIT_TOL / T; the paged session's tokens equal the
    dense session's; kernels A and B launch as often as in the greedy
    runs, and no other kernel; a sampled session refuses
    ``speculative=``."""
    import torch
    from repro_torch.core import execution as ex
    from repro_torch.core import prng
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.runtime.serve_loop import (
        ServeSession, make_prefill_step, make_serve_step)
    t_phase = time.perf_counter()
    temp = SAMPLE_TEMPERATURE
    tol = LOGIT_TOL["bf16"] / temp

    def session(paged=False, **kw):
        if paged:
            kw.update(paged=True, page_size=PAGE_SIZE, pages=PAGES)
        return ServeSession(
            params, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
            rt=RuntimeCfg(use_pallas=True),
            policy=ex.parse_policy("bf16:dense:hopper"), temperature=temp,
            seed=SEED, device="cuda", **kw)

    try:
        session(speculative={"k": 4, "draft_policy": "bf16:dense:hopper"})
    except ValueError as e:
        print(f"[sample] temperature {temp} with speculative=: refused "
              f"(ValueError: {e})", flush=True)
    else:
        fail("[sample] a sampled session accepted speculative=")

    key, keys = prng.PRNGKey(SEED), []
    for _ in range(3):
        key, sub = prng.split(key)
        keys.append(sub)
    res = check_sampler_bits(keys, cfg.padded_vocab)

    torch_policy = ex.parse_policy("bf16:dense:torch")
    torch_prefill = make_prefill_step(cfg, RuntimeCfg(), policy=torch_policy)
    torch_step = make_serve_step(cfg, RuntimeCfg(), policy=torch_policy)
    teacher = (lambda p, prompt: torch_prefill(p, prompt)[0],
               lambda p, *state: torch_step(p, *state)[1])
    hop = session()
    zero_launch_counts()
    run = drive(hop, requests(), teacher=teacher)
    launches = launch_counts()
    del hop
    check_completed(SAMPLE_TAG, run)
    flips = [t for t in run["teacher"] if t[2] != t[3]]
    ties = [t for t in run["teacher"] if t[4] < tol]
    print(f"[sample] {SAMPLE_TAG} T={temp}: {len(run['teacher'])} tokens "
          f"({len(run['prefill_s'])} admissions, {len(run['decode_s'])} "
          f"decode steps) against argmax(torch backend logits / T + the "
          f"step's gumbel), teacher forced: {len(flips)} differ "
          f"(top-2 margins {[round(t[4], 4) for t in flips]}), "
          f"{len(ties)} near-ties under {tol:.4f}", flush=True)
    off = [t for t in flips if t[4] >= tol]
    if off:
        fail(f"[sample] {SAMPLE_TAG}: tokens {[t[:2] for t in off]} differ "
             f"from the torch backend's at margins >= {tol:.4f}")
    print(f"[sample] {SAMPLE_TAG}: launches {launches}, greedy run's "
          f"{greedy['launches']}", flush=True)
    if launches != greedy["launches"]:
        fail(f"{SAMPLE_TAG}: kernel launches {launches}, the greedy run's "
             f"{greedy['launches']}")

    pag = session(paged=True)
    zero_launch_counts()
    prun = drive(pag, requests())
    plaunches = launch_counts()
    del pag
    check_completed(SAMPLE_PAGED_TAG, prun)
    same = sum(prun["outs"][u] == run["outs"][u] for u in run["outs"])
    print(f"[sample] {SAMPLE_PAGED_TAG}: sampled tokens equal to the dense "
          f"sampled run for {same}/{N_REQUESTS} requests; launches "
          f"{plaunches}, greedy paged run's {greedy_paged['launches']}",
          flush=True)
    if same != N_REQUESTS:
        fail(f"{SAMPLE_PAGED_TAG}: sampled tokens differ from the dense run")
    if plaunches != greedy_paged["launches"]:
        fail(f"{SAMPLE_PAGED_TAG}: kernel launches {plaunches}, the greedy "
             f"paged run's {greedy_paged['launches']}")
    if run["outs"] == greedy_outs:
        fail(f"{SAMPLE_TAG}: the sampled tokens are the greedy run's")

    res.update(profile_sampler(cfg.padded_vocab, keys[0]))
    out = {}
    for tag, r, base, lau in ((SAMPLE_TAG, run, greedy, launches),
                              (SAMPLE_PAGED_TAG, prun, greedy_paged,
                               plaunches)):
        out[tag] = dict(run_times(tag, r), launches=lau, temperature=temp,
                        greedy_decode_ms_median=base["decode_ms_median"],
                        greedy_decode_ms_p67=base["decode_ms_p67"])
    out[SAMPLE_TAG].update(
        res, teacher_tokens=len(run["teacher"]), teacher_flips=len(flips),
        teacher_near_ties=len(ties), near_tie_margin=tol)
    out[SAMPLE_PAGED_TAG]["tokens_equal_dense"] = same
    prof = profile_decode(session(), requests(),
                          out[SAMPLE_TAG]["decode_ms_per_step"])
    out[SAMPLE_TAG].update(prof)
    if prof.get("kernels_per_step") and greedy.get("kernels_per_step"):
        out[SAMPLE_TAG]["step_kernels_over_greedy"] = \
            prof["kernels_per_step"] - greedy["kernels_per_step"]
    for tag, r in out.items():
        print(f"[sample-time] {json.dumps(r)}", flush=True)
    print(f"[sample] phase {time.perf_counter() - t_phase:.1f}s", flush=True)
    return out


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


def packed_leaves(tree) -> int:
    """Packed 2:4 weights in a parameter tree."""
    from repro_torch.core import execution as ex
    if isinstance(tree, dict):
        return sum(packed_leaves(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(packed_leaves(v) for v in tree)
    return int(isinstance(tree, ex.PackedWeight))


def serve_sparse24(params, cfg, requests, max_len=MAX_LEN,
                   tag="bf16:sparse24:hopper"):
    """``bf16:sparse24:hopper``: the session prunes and packs the weights
    at construction (timed here) and runs every packed linear on kernel D,
    the LM head on kernel A and prefill attention on kernel B. The torch-
    backend session and twin step take the same packed weights. A
    recurrent stack's packed prefill is held sublayer by sublayer
    (``layerwise_check``) and to an f32 run (``prefill_against_f32``)."""
    import torch
    from repro_torch.core import execution as ex
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.runtime.serve_loop import ServeSession, make_serve_step

    def session(p, backend, use_pallas):
        return ServeSession(
            p, cfg, batch_slots=SLOTS, max_len=max_len,
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
    n_packed = packed_leaves(packed)
    print(f"[serve] {tag}: pruned and packed {n_packed} linears in "
          f"{pack_s:.2f}s on the card; weights {packed_gib:.2f} GiB packed "
          f"(embed, head, norms dense) against {dense_gib:.2f} GiB dense",
          flush=True)
    check_pack_on_cpu(params, packed)
    held = {}
    if cfg.ssm_kind:
        # the f32 run takes the packed weights' pruned dense form, the
        # pack itself held to the CPU's just above
        prompts = [r.prompt for r in requests()[:2]]
        held.update(layerwise_check(tag, cfg, packed, prompts,
                                    "bf16:sparse24", {}))
        held.update(prefill_against_f32(tag, cfg, packed, tree_f32(packed),
                                        prompts[0], "bf16", {}))

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
    res = check_serve(tag, run, base, launches, cfg, "bf16:sparse24:hopper")
    res.update(held)
    # every packed linear on D, the head alone on A, prefill attention on B
    steps = len(run["prefill_s"]) + len(run["decode_s"])
    per_step = linears_per_step(cfg)
    want = {"gemm": steps,
            "flash_attention": attention_layers(cfg) * len(run["prefill_s"]),
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
    """Layer 0's narrowest packed weight (the likeliest to trip the pack's
    tiling), pruned and packed on the card by the session, has the bytes
    ``pack_model_params`` gives on the CPU."""
    import torch
    from repro_torch.core import execution as ex
    layer = packed["layers"][0]
    group, name = min(((g, n) for g in layer if isinstance(layer[g], dict)
                       for n, v in layer[g].items()
                       if isinstance(v, ex.PackedWeight)),
                      key=lambda gn: layer[gn[0]][gn[1]].values.shape[-1])
    w = params["layers"][0][group][name]
    t0 = time.perf_counter()
    cpu = ex.pack_model_params({"layers": [{group: {name: w.cpu()}}]})
    cpu = cpu["layers"][0][group][name]
    card = packed["layers"][0][group][name]
    same = torch.equal(card.meta.cpu(), cpu.meta) and torch.equal(
        card.values.cpu().view(torch.int16), cpu.values.view(torch.int16))
    print(f"[sparse24] pack_model_params of layer 0 {group}.{name} "
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



# ---------------------------------------------------------------------------
# [moe] and [local]: the MoE and local/global block kinds at full size
# ---------------------------------------------------------------------------

MOE_ARCH, LOCAL_ARCH = "granite-moe-3b-a800m", "gemma3-12b"
# gemma3: one prompt past the 1024-row window (its local caches roll at
# prefill and decode wraps them), the others as in the llama3 runs
LOCAL_PROMPT_LENS = (1040, 77, 128, 77, 128, 77, 128, 77)
LOCAL_MAX_LEN = 1152
# the paged pool: the long request holds 66 pages of 16 rows (1040 + 15
# positions), three short ones at most 9 each: 93 pages at the peak
LOCAL_PAGES = 96
LOCAL_SPEC_K = 4


# Kernel A launches per layer and step, by block kind (models/mamba2.py:
# the five input projections and out_proj; models/rwkv6.py: r, k, v, g, w
# and o of the time mix and the channel mix's three); every other kind has
# 4 attention linears and 3 FFN GEMMs.
GEMMS_PER_KIND = {"mamba2": 6, "rwkv6": 9}


def linears_per_step(cfg) -> int:
    """Kernel-A (or, packed, kernel-D) GEMMs of one step over every layer,
    the LM head not counted; a MoE layer's expert GEMMs count once each
    (one batched launch per weight)."""
    from repro_torch.models.transformer import layer_kinds
    kinds = layer_kinds(cfg)
    moe = sum(k == "attn_moe" for k in kinds)
    shared = 3 * moe if cfg.moe_shared_expert else 0
    return sum(GEMMS_PER_KIND.get(k, 7) for k in kinds) + shared


def attention_layers(cfg) -> int:
    """The layers of ``cfg`` that prefill through kernel B: every
    attention layer but the local ones (they prefill through the chunked
    path, as in the reference), zamba2's shared-attention invocations
    included."""
    from repro_torch.models.transformer import STATE_KINDS, layer_kinds
    return sum(k not in ("attn_local",) + STATE_KINDS
               for k in layer_kinds(cfg))


def block_launches_expected(cfg, n_prefills: int, n_steps: int) -> dict:
    """The launches a dense-policy run of ``cfg`` must make: per prefill
    and per decode (or verify, or draft) step, kernel A for each layer's
    linears (``linears_per_step``: 4 attention linears and the FFN's 3
    GEMMs, a MoE layer's 3 expert-batched, one launch over all experts
    each, and its shared expert adding 3 plain ones; 6 per mamba2 layer; 9
    per rwkv6 layer) and once for the head; kernel B once per
    ``attention_layers`` layer per prefill."""
    from repro_torch.models.transformer import layer_kinds
    moe = sum(k == "attn_moe" for k in layer_kinds(cfg))
    n = n_prefills + n_steps
    return {"launches": {"gemm": (linears_per_step(cfg) + 1) * n,
                         "flash_attention": n_prefills
                         * attention_layers(cfg),
                         "paged_attention": 0, "sparse24_gemm": 0,
                         "block24_gemm": 0},
            "batched": 3 * moe * n}


# hopper-vs-torch tolerance of one sublayer's output given the same
# input, relative to the output's largest magnitude: outputs are rounded
# to bf16 (2^-8 relative) and the two backends' f32 sums part by an ulp or
# two of the bf16 operands between GEMMs (kernel B also rounds P to
# bf16): ~5 ulps. fp8: the two may take an e4m3 rounding (2^-3 relative
# at worst) on either side for an element of a quantized operand.
LAYER_TOL = {"bf16": 2e-2, "fp8": 0.125}


def layerwise_check(tag, cfg, params, prompts, policy, rt_kw) -> dict:
    """The hopper path against the torch backend under ``policy``
    (precision:sparsity; packed 2:4 ``params`` under ``sparse24``)
    sublayer by sublayer, teacher forced: each prompt's embedding goes
    through every layer, and each sublayer (attention, mamba2 mixer or
    rwkv6 time mix; the MoE layer, MLP or rwkv6 channel mix) runs under
    both backends on the same input, the hopper output feeding on. Each
    pair must agree within LAYER_TOL. A MoE sublayer then routes both
    runs from one input, so the check holds its expert GEMMs (one batched
    launch per weight) to the plain path. End to end, and even within one
    layer, a bf16 ulp upstream of the router can move a token across an
    expert's top-k or capacity cut, and the two runs route differently
    from there on: LOGIT_TOL cannot hold for a MoE stack."""
    import torch
    from repro_torch.core import execution as ex
    from repro_torch.models import mamba2 as m2
    from repro_torch.models import rwkv6 as rk
    from repro_torch.models.attention import attention_block
    from repro_torch.models.layers import RuntimeCfg, embed_tokens, rms_norm
    from repro_torch.models.transformer import (block_params, ffn,
                                                layer_kinds)
    sides = {be: ex.apply_policy(cfg, RuntimeCfg(use_pallas=be == "hopper",
                                                 **rt_kw),
                                 ex.parse_policy(f"{policy}:{be}"))
             for be in ("hopper", "torch")}
    worst = {}

    def both(name, where, fn):
        out = {be: fn(*sides[be]) for be in sides}
        ref = out["torch"].float()
        rel = float((out["hopper"].float() - ref).abs().max()
                    / ref.abs().max().clamp_min(1e-30))
        if rel >= worst.get(name, (0.0, None))[0]:
            worst[name] = (rel, where)
        return out["hopper"]

    for prompt in prompts:
        tokens = torch.as_tensor(prompt, device="cuda").long()[None]
        x = embed_tokens(tokens, params["embed"]).to(torch.bfloat16)
        for li, (kind, p) in enumerate(zip(layer_kinds(cfg),
                                           params["layers"])):
            p = block_params(kind, p, params)
            where = (len(prompt), li, kind)
            h = rms_norm(x, p["norm1"], cfg.norm_eps)
            if kind == "mamba2":
                x = x + both("mamba2", where, lambda c, rt: m2.mamba2_block(
                    h, p["mamba"], c, rt))
                continue
            if kind == "rwkv6":
                x = x + both("rwkv6 time mix", where,
                             lambda c, rt: rk.rwkv6_block(h, p["rwkv"], c,
                                                          rt))
                h = rms_norm(x, p["norm2"], cfg.norm_eps)
                x = x + both("rwkv6 channel mix", where,
                             lambda c, rt: rk.rwkv6_channel_mix(
                                 h, p["rwkv"], c, rt))
                continue
            window = cfg.window_size if kind == "attn_local" else 0
            x = x + both("attention", where,
                         lambda c, rt: attention_block(h, p["attn"], c, rt,
                                                       window=window))
            h = rms_norm(x, p["norm2"], cfg.norm_eps)
            x = x + both("ffn", where, lambda c, rt: ffn(kind, h, p, c, rt))
    tol = LAYER_TOL[policy.split(":")[0]]
    print(f"[{tag}] sublayer by sublayer against the torch backend (teacher "
          f"forced, prompts {[len(p) for p in prompts]}): worst max|err|/"
          f"max|out| " + ", ".join(f"{name} {w:.3e} at (prompt, layer, "
                                   f"kind) {at}" for name, (w, at)
                                   in worst.items())
          + f" (tolerance {tol})", flush=True)
    if not max(w for w, _ in worst.values()) <= tol:
        fail(f"{tag}: a sublayer differs from the torch backend beyond {tol}")
    return {"sublayer_worst_rel": {k: w for k, (w, _) in worst.items()}}


# A recurrent stack's first prefill against an f32 run of the same
# weights: the hopper logits may lie at most this factor farther from it
# than the torch backend's (the bf16 rule of
# tests/test_torch_local_attention.py; ROADMAP §3 says why LOGIT_TOL
# cannot hold these stacks' prefill).
F32_FACTOR = 1.5


def tree_f32(tree):
    """A parameter tree with every tensor upcast to f32, a packed 2:4
    weight unpacked (its pruned dense weight)."""
    from repro_torch.core import execution as ex
    from repro_torch.core import sparsity as sp
    if isinstance(tree, dict):
        return {k: tree_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_f32(v) for v in tree]
    if isinstance(tree, ex.PackedWeight):
        return sp.unpack_24(tree.values, tree.meta).float()
    return tree.float()


def recurrent_stack(cfg, params, tokens, policy, rt_kw, act=None,
                    trace=None):
    """A prompt's last-token logits (f32) through every layer's
    ``prefill_block`` under ``policy`` (precision:sparsity:backend), with
    activations in ``act`` (default bf16), starting from ``tokens``'
    embedding or from the (1, S, d) activations ``tokens`` itself.
    ``trace``, a list, gets each layer's output."""
    import torch
    from repro_torch.core import execution as ex
    from repro_torch.models.layers import (RuntimeCfg, embed_tokens,
                                           lm_logits, rms_norm)
    from repro_torch.models.transformer import (block_params, layer_kinds,
                                                prefill_block)
    act = act or torch.bfloat16
    c, rt = ex.apply_policy(cfg, RuntimeCfg(use_pallas=policy.endswith(
        ":hopper"), act_dtype=act, **rt_kw), ex.parse_policy(policy))
    x = (tokens if tokens.is_floating_point()
         else embed_tokens(tokens, params["embed"])).to(act)
    for kind, lp in zip(layer_kinds(cfg), params["layers"]):
        x, _ = prefill_block(kind, x, block_params(kind, lp, params), c, rt)
        if trace is not None:
            trace.append(x.float())
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(x[:, -1], params["head"], cfg.vocab_size,
                     policy=ex.policy_from(c, rt)).float()


def prefill_against_f32(tag, cfg, params, p32, prompt, precision,
                        rt_kw) -> dict:
    """One prompt's last-token logits under the hopper and the torch
    backends, and under the torch backend in f32 (f32 weights and
    activations, no quantization): the hopper logits' distance from the
    f32 run must be at most F32_FACTOR times the torch backend's."""
    import torch
    tokens = torch.as_tensor(prompt, device="cuda").long()[None]
    hop = recurrent_stack(cfg, params, tokens, f"{precision}:dense:hopper",
                          rt_kw)
    ref = recurrent_stack(cfg, params, tokens, f"{precision}:dense:torch",
                          rt_kw)
    f32 = recurrent_stack(cfg, p32, tokens, "bf16:dense:torch", rt_kw,
                          act=torch.float32)
    out = {"prompt": len(prompt),
           "hopper_vs_f32": float((hop - f32).abs().max()),
           "torch_vs_f32": float((ref - f32).abs().max()),
           "hopper_vs_torch": float((hop - ref).abs().max())}
    print(f"[{tag}] first prefill ({len(prompt)} tokens) against an f32 run:"
          f" hopper {out['hopper_vs_f32']:.4f}, torch "
          f"{out['torch_vs_f32']:.4f} (hopper at most {F32_FACTOR}x torch); "
          f"hopper vs torch {out['hopper_vs_torch']:.4f}", flush=True)
    if not out["hopper_vs_f32"] <= F32_FACTOR * out["torch_vs_f32"]:
        fail(f"{tag}: the hopper prefill logits lie "
             f"{out['hopper_vs_f32']:.4f} from an f32 run, over "
             f"{F32_FACTOR} x the torch backend's {out['torch_vs_f32']:.4f}")
    return {"prefill_against_f32": out}


def diagnose_recurrent() -> None:
    """``--diagnose-recurrent``'s serving half: why the recurrent stacks'
    first-prefill logits part between the backends by more than LOGIT_TOL (ROADMAP §3).
    For each recurrent model at its published size and each precision its
    phase serves, one prompt: the two backends' free-running hidden states
    layer by layer (max|diff| / max|torch|), and how far one bf16 ulp on
    the input embedding (a random sign per element) moves the torch
    backend's own logits. Gates nothing; prints one JSON line per run."""
    import torch
    for arch, lens, precisions in ((SSM_ARCH, SSM_PROMPT_LENS,
                                    ("bf16", "fp8")),
                                   (HYBRID_ARCH, HYBRID_PROMPT_LENS,
                                    ("bf16",))):
        cfg, params = block_model(arch)
        prompt = block_requests(cfg, lens)()[0].prompt
        tokens = torch.as_tensor(prompt, device="cuda").long()[None]
        for precision in precisions:
            gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
            th, tt = [], []
            hop = recurrent_stack(cfg, params, tokens,
                                  f"{precision}:dense:hopper", {}, trace=th)
            ref = recurrent_stack(cfg, params, tokens,
                                  f"{precision}:dense:torch", {}, trace=tt)
            x = params["embed"][tokens].to(torch.bfloat16)
            sign = torch.where(torch.rand(x.shape, generator=gen,
                                          device="cuda") < 0.5, -1.0, 1.0)
            x = (x.float() * (1 + 2 ** -7 * sign)).to(torch.bfloat16)
            nudged = recurrent_stack(cfg, params, x,
                                     f"{precision}:dense:torch", {})
            out = {"arch": arch, "precision": precision,
                   "prompt": len(prompt),
                   "hopper_vs_torch": float((hop - ref).abs().max()),
                   "torch_vs_torch_one_ulp_input":
                       float((nudged - ref).abs().max()),
                   "free_running_rel_diff_by_layer": [
                       float((a - b).abs().max()
                             / b.abs().max().clamp_min(1e-30))
                       for a, b in zip(th, tt)]}
            print(f"[diagnose] {json.dumps(out)}", flush=True)
        del params
        torch.cuda.empty_cache()


# free device memory a served model needs beyond its bf16 weights: caches,
# the torch backend's f32 copy of a weight (2 GiB for chameleon-34b's
# head), logits
MODEL_HEADROOM = 4 * 2**30


def block_model(arch, layers=None):
    """A full-size config's random weights on the card, from the seed;
    with ``layers``, its first ``layers`` layers only (a depth cut). Fails
    with the figures, before it allocates, where the card has less free
    than the bf16 weights and MODEL_HEADROOM."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    full = get_arch(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          num_layers=layers)
    cut = "no depth cut" if layers is None else \
        f"depth cut from {full.num_layers}"
    # the earlier phases' freed blocks, still cached by the allocator
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    need = 2 * cfg.param_count() + MODEL_HEADROOM
    print(f"[{arch}] {free / 2**30:.2f} GiB free of {total / 2**30:.2f} "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated by "
          f"this process); the weights and headroom need "
          f"{need / 2**30:.2f}", flush=True)
    if free < need:
        fail(f"{arch}: {free / 2**30:.2f} GiB free, {need / 2**30:.2f} GiB "
             "needed")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    ssm = ""
    if cfg.ssm_kind == "mamba2":
        ssm = (f", mamba2: d_inner {cfg.ssm_d_inner}, state "
               f"{cfg.ssm_state}, {cfg.ssm_nheads} heads of "
               f"{cfg.ssm_head_dim}, chunk {cfg.ssm_chunk}")
    elif cfg.ssm_kind == "rwkv6":
        ssm = (f", rwkv6: {cfg.d_model // cfg.ssm_head_dim} heads of "
               f"{cfg.ssm_head_dim}, chunk {cfg.ssm_chunk}")
    print(f"[{arch}] {cfg.num_layers} layers {cfg.superlayer_pattern} x "
          f"{cfg.num_superlayers} + {cfg.hybrid_tail_layers} tail ({cut}), "
          f"d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, heads {cfg.num_heads}/{cfg.num_kv_heads}, hd "
          f"{cfg.head_dim}, vocab {cfg.vocab_size} (padded "
          f"{cfg.padded_vocab}), experts {cfg.num_experts} top "
          f"{cfg.experts_top_k}, window {cfg.window_size}{ssm}; "
          f"{cfg.param_count() / 1e9:.2f} B params, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card, "
          f"init {time.perf_counter() - t0:.1f}s", flush=True)
    return cfg, params


def block_requests(cfg, lens):
    import numpy as np
    from repro_torch.runtime.serve_loop import Request
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in lens]
    return lambda: [Request(uid=i, prompt=p, max_new=MAX_NEW)
                    for i, p in enumerate(prompts)]


def check_block_launches(tag, cfg, n_prefills, n_steps, launches,
                         batched) -> dict:
    want = block_launches_expected(cfg, n_prefills, n_steps)
    print(f"[{tag}] launches {launches}, expert-batched A {batched}; "
          f"expected {want}", flush=True)
    if launches != want["launches"] or batched != want["batched"]:
        fail(f"{tag}: kernel launches {launches} (expert-batched "
             f"{batched}), expected {want}")
    return want


def serve_block(arch, cfg, params, requests, max_len, rt_kw, precisions,
                paged_pages):
    """One full-size model through ``ServeSession``: for each precision a
    ``{p}:dense:hopper`` run held against a ``torch``-backend run
    (``serve_against_torch``: logits within LOGIT_TOL and tokens equal up
    to a near-tie, or, for a MoE stack, sublayer by sublayer,
    ``layerwise_check``) with its launches exact
    (``block_launches_expected``); the bf16 run once more from a paged
    cache of ``paged_pages`` pages, whose tokens and first logits must
    equal the dense run's bit for bit. Returns the results by tag and the
    bf16 dense run."""
    from repro_torch.core import execution as ex
    from repro_torch.kernels import fp8_matmul as fm
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.runtime.serve_loop import ServeSession

    results, dense_run = {}, None
    recurrent = bool(cfg.ssm_kind)
    p32 = tree_f32(params) if recurrent else None
    for precision in precisions:
        tag = f"{arch} {precision}:dense:hopper"
        moe = bool(cfg.num_experts)
        prompts = [r.prompt for r in requests()[:2]]
        held = {}
        if moe or recurrent:
            held.update(layerwise_check(tag, cfg, params, prompts,
                                        f"{precision}:dense", rt_kw))
        if recurrent:
            held.update(prefill_against_f32(tag, cfg, params, p32,
                                            prompts[0], precision, rt_kw))
        res, run, launches, batched = serve_against_torch(
            cfg, params, requests, precision, tag, max_len, rt_kw)
        res.update(held)
        check_block_launches(tag, cfg, len(run["prefill_s"]),
                             len(run["decode_s"]), launches, batched)
        results[tag] = res
        if precision != "bf16":
            continue
        dense_run = run
        sess = ServeSession(
            params, cfg, batch_slots=SLOTS, max_len=max_len,
            rt=RuntimeCfg(use_pallas=True, **rt_kw),
            policy=ex.parse_policy(f"{precision}:dense:hopper"),
            device="cuda", paged=True, page_size=PAGE_SIZE,
            pages=paged_pages)
        zero_launch_counts()
        prun = drive(sess, requests())
        plaunches, pbatched = launch_counts(), fm.BATCHED_LAUNCHES
        pwidths = dict(fm.WIDTH_LAUNCHES)
        peak = sess.pager.stats()["peak_pages_in_use"]
        del sess
        ptag = f"{tag} paged"
        check_completed(ptag, prun)
        same = sum(prun["outs"][u] == run["outs"][u] for u in run["outs"])
        rows = prun["first"]["decode_rows"]
        pre = float((prun["first"]["prefill"]
                     - run["first"]["prefill"]).abs().max())
        dec = float((prun["first"]["decode"][rows]
                     - run["first"]["decode"][rows]).abs().max())
        print(f"[{ptag}] greedy tokens equal to the dense run for "
              f"{same}/{N_REQUESTS} requests; first prefill max_abs_diff="
              f"{pre}, first decode max_abs_diff={dec}; peak {peak} of "
              f"{paged_pages} pages of {PAGE_SIZE}", flush=True)
        if same != N_REQUESTS or pre != 0.0 or dec != 0.0:
            fail(f"{ptag}: tokens or logits differ from the dense run")
        if plaunches != launches or pbatched != batched:
            fail(f"{ptag}: launches {plaunches} ({pbatched} batched), the "
                 f"dense run's {launches} ({batched})")
        results[ptag] = dict(run_times(ptag, prun), launches=plaunches,
                             expert_batched_launches=pbatched,
                             gemm_launches_by_width=pwidths,
                             tokens_equal_dense=same, pages=paged_pages,
                             peak_pages_in_use=peak,
                             first_prefill_diff=pre, first_decode_diff=dec)
        print(f"[serve-time] {json.dumps(results[ptag])}", flush=True)
    del p32
    return results, dense_run


def moe_phase():
    """[moe] granite-moe-3b-a800m at its published size: 32 layers of
    attention and 40 experts (top 8, expert d_ff 512), every expert GEMM
    on kernel A's expert-batched launch; ``bf16:dense:hopper`` dense and
    paged and ``fp8:dense:hopper``, each against a torch-backend run."""
    import torch
    t0 = time.perf_counter()
    cfg, params = block_model(MOE_ARCH)
    results, _ = serve_block(MOE_ARCH, cfg, params,
                             block_requests(cfg, [PROMPT_LENS[i % 2] for i
                                                  in range(N_REQUESTS)]),
                             MAX_LEN, {}, ("bf16", "fp8"), PAGES)
    del params
    torch.cuda.empty_cache()
    print(f"[{MOE_ARCH}] phase took {time.perf_counter() - t0:.1f}s",
          flush=True)
    return results


# llama4-scout at its published width, cut in depth: its 48 layers hold
# 107.7 B params (215 GB in bf16), 8 of them 19.7 B (39 GB)
TOP1_ARCH, TOP1_LAYERS = "llama4-scout-17b-a16e", 8


def moe_top1_phase():
    """[moe-top1] llama4-scout-17b-a16e at its published width, 8 of its
    48 layers: 16 experts, top 1, capacity ceil(1.25 * tokens / 16) per
    group, and a shared SwiGLU expert beside them (its three GEMMs plain
    kernel-A launches; the experts' one expert-batched launch each), 40
    query heads over 8 kv heads on kernel B; ``bf16:dense:hopper`` dense
    and paged against a torch-backend run, held sublayer by sublayer (a
    top-1 router flips at near-ties, ROADMAP §3)."""
    import torch
    t0 = time.perf_counter()
    cfg, params = block_model(TOP1_ARCH, layers=TOP1_LAYERS)
    results, _ = serve_block(TOP1_ARCH, cfg, params,
                             block_requests(cfg, [PROMPT_LENS[i % 2] for i
                                                  in range(N_REQUESTS)]),
                             MAX_LEN, {}, ("bf16",), PAGES)
    del params
    torch.cuda.empty_cache()
    print(f"[{TOP1_ARCH}] phase took {time.perf_counter() - t0:.1f}s",
          flush=True)
    return results


# [dense-wide]: the three dense stacks widest on the card, (arch, layers
# kept or None for the whole stack, prompt lengths, precisions, paged
# pool). chameleon-34b whole (34.29 B params, 63.9 GiB in bf16; d 8192,
# d_ff 22016, 64 query heads over 8 kv heads), 8 prompts of 128 tokens, so
# that the serving CLI's --prompt-len 128 draws the same ones (4 slots of
# 144 positions: 36 pages of 16); deepseek-67b (the same layer, a head of
# 102400) at 4 of its 95 layers (4.45 B); llama3-405b (d 16384, d_ff
# 53248, 128 over 8 heads, a head of 128256) at 2 of its 126 (10.58 B,
# 19.7 GiB), also under fp8; both with the 128/77 prompts of the llama3
# runs. (At 8 and 4 layers the whole script took 1,192 s of its 1,200 on
# a slow host: the two depth cuts are halved to keep within the clock.)
DENSE_WIDE = (("chameleon-34b", None, (128,), ("bf16",), 36),
              ("deepseek-67b", 4, PROMPT_LENS, ("bf16",), PAGES),
              ("llama3-405b", 2, PROMPT_LENS, ("bf16", "fp8"), PAGES))
# the serving CLI, as a user runs it, on chameleon-34b whole: it draws its
# weights (torch.Generator(device).manual_seed(seed), init_params) and its
# prompts (default_rng(seed), one integers draw per request) as
# block_model and block_requests do, so its tokens are [dense-wide]'s
WIDE_CLI_ARCH = "chameleon-34b"
WIDE_CLI_ARGV = ("--arch", WIDE_CLI_ARCH, "--device", "cuda",
                 "--backend", "hopper", "--requests", str(N_REQUESTS),
                 "--prompt-len", "128", "--max-new", str(MAX_NEW),
                 "--slots", str(SLOTS), "--max-len", str(MAX_LEN),
                 "--seed", str(SEED))


def cli_first_tokens(stdout: str) -> dict:
    """{uid: tokens} of the ``req`` lines the serving CLI prints (the
    first 8 tokens of the first 4 requests it completed)."""
    import re
    return {int(m.group(1)): [int(t) for t in m.group(2).split(",")]
            for m in re.finditer(r"^  req (\d+): \d+ new tokens, first 8: "
                                 r"\[([^\]]*)\]$", stdout, re.M)}


def serve_cli_check(tag, argv, dense_run, dense_launches) -> dict:
    """``repro_torch.launch.serve.main(argv)`` in this process (no second
    CUDA context beside the weights), its standard output captured: it
    must return 0, complete every request, launch the kernels the dense
    run launched, and print for each request it lists the first tokens of
    ``dense_run``'s request of the same uid."""
    import contextlib
    import io
    import torch
    from repro_torch.kernels import fp8_matmul as fm
    from repro_torch.launch import serve as serve_cli
    buf = io.StringIO()
    zero_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_cli.main(list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, widths = launch_counts(), dict(fm.WIDTH_LAUNCHES)
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"[{tag}] | {line}", flush=True)
    got = cli_first_tokens(out)
    same = sum(toks == dense_run["outs"][uid][:len(toks)]
               for uid, toks in got.items())
    done = f"[serve] {N_REQUESTS}/{N_REQUESTS} requests, " \
        f"{N_REQUESTS * MAX_NEW} tokens"
    print(f"[{tag}] python -m repro_torch.launch.serve {' '.join(argv)}: rc "
          f"{rc} in {wall:.1f}s (weights made in it); tokens of uids "
          f"{sorted(got)} equal to the dense run's for {same}/{len(got)}; "
          f"launches {launches}, the dense run's {dense_launches}",
          flush=True)
    if rc != 0 or done not in out:
        fail(f"{tag}: rc {rc}, or no line '{done}'")
    if len(got) != min(4, N_REQUESTS) or same != len(got):
        fail(f"{tag}: tokens {got} differ from the dense run's")
    if launches != dense_launches:
        fail(f"{tag}: launches {launches}, the dense run's {dense_launches}")
    return {"policy": tag, "rc": rc, "seconds": wall, "launches": launches,
            "expert_batched_launches": 0, "gemm_launches_by_width": widths,
            "uids": sorted(got),
            "tokens_equal_dense": same}


def dense_wide_phase():
    """[dense-wide] the DENSE_WIDE arms at their published width, each
    through ``serve_block``: every precision's ``{p}:dense:hopper`` run
    against a torch-backend run (logits within LOGIT_TOL, tokens equal up
    to a near-tie), launches exact, the bf16 run once more from a paged
    cache, bit-equal; chameleon-34b whole, then the serving CLI on it
    (``serve_cli_check``). Each arm's weights are freed before the next
    (``block_model`` checks the free memory against them first)."""
    import torch
    t_phase = time.perf_counter()
    results = {}
    for arch, layers, lens, precisions, pages in DENSE_WIDE:
        t0 = time.perf_counter()
        cfg, params = block_model(arch, layers=layers)
        requests = block_requests(cfg, [lens[i % len(lens)]
                                        for i in range(N_REQUESTS)])
        res, dense = serve_block(arch, cfg, params, requests, MAX_LEN, {},
                                 precisions, pages)
        del params
        torch.cuda.empty_cache()
        if arch == WIDE_CLI_ARCH:
            tag = f"{arch} CLI"
            res[tag] = serve_cli_check(
                tag, WIDE_CLI_ARGV, dense,
                res[f"{arch} bf16:dense:hopper"]["launches"])
            torch.cuda.empty_cache()
        for tag, r in res.items():
            # the head's launches, counted where kernel A launches (its
            # output width, the padded vocab, is no other linear's): once
            # per prefill and per decode step, a share of the gated total
            r["head_launches"] = r["gemm_launches_by_width"].get(
                cfg.padded_vocab, 0)
            steps = r["launches"]["gemm"] // (linears_per_step(cfg) + 1)
            print(f"[{tag}] head (N={cfg.padded_vocab}) launches "
                  f"{r['head_launches']} over {steps} prefills and decode "
                  "steps", flush=True)
            if r["head_launches"] != steps:
                fail(f"{tag}: the head launched {r['head_launches']} times "
                     f"over {steps} prefills and decode steps")
        results.update(res)
        print(f"[{arch}] took {time.perf_counter() - t0:.1f}s", flush=True)
    print(f"[dense-wide] phase {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return results


def spec_block(arch, cfg, params, requests, max_len, rt_kw, draft, k,
               dense) -> dict:
    """A speculative session of ``cfg`` (``bf16:dense:hopper`` verify,
    ``draft`` policy, depth ``k``) over ``requests``: its greedy tokens
    must equal the plain run ``dense``'s, its launches the counts its
    prefills, verify steps and draft steps imply; a bf16 draft (the
    verify's own computation) must have every draft accepted, any other
    some rejected, so that the rollback of rejected steps ran."""
    from repro_torch.core import execution as ex
    from repro_torch.kernels import fp8_matmul as fm
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.runtime.serve_loop import ServeSession
    tag = f"{arch} spec {draft.split(':')[0]}-draft k{k}"
    sess = ServeSession(
        params, cfg, batch_slots=SLOTS, max_len=max_len,
        rt=RuntimeCfg(use_pallas=True, **rt_kw),
        policy=ex.parse_policy("bf16:dense:hopper"),
        speculative={"k": k, "draft_policy": draft}, device="cuda")
    zero_launch_counts()
    run = drive_spec(sess, requests())
    launches, by_type = launch_counts(), dict(fm.TYPE_LAUNCHES)
    totals = {key: sum(t[key] for t in sess.spec_totals.values())
              for key in ("steps", "drafted", "accepted", "committed")}
    del sess
    same = sum(run["outs"][u] == dense["outs"][u] for u in dense["outs"])
    drafts = sum(d - 1 for d in run["depths"])
    want = block_launches_expected(cfg, len(run["prefill_s"]),
                                   sum(run["depths"]) + drafts)
    n_tok = sum(len(o) - 1 for o in run["outs"].values())
    plain_tok = sum(len(o) - 1 for o in dense["outs"].values())
    res = {"policy": tag, "draft_policy": draft, "k": k,
           "requests": len(run["outs"]), "tokens_equal_plain": same,
           "decode_steps": len(run["decode_s"]), "acceptance": totals,
           "accept_rate": totals["accepted"] / max(1, totals["drafted"]),
           "launches": launches, "gemm_by_type": by_type, "expected": want,
           "ms_per_committed_token": 1e3 * sum(run["decode_s"]) / n_tok,
           "plain_ms_per_committed_token":
               1e3 * sum(dense["decode_s"]) / plain_tok,
           "decode_ms_per_step": mean_ms(run["decode_s"]),
           "prefill_ms": mean_ms(run["prefill_s"])}
    print(f"[{tag}] greedy tokens equal to the plain bf16:dense:hopper run "
          f"for {same}/{N_REQUESTS} requests; drafted {totals['drafted']} "
          f"accepted {totals['accepted']}; launches {launches} (A by type "
          f"{by_type}), expected {want['launches']}", flush=True)
    print(f"[spec-time] {json.dumps(res)}", flush=True)
    if same != N_REQUESTS:
        fail(f"{tag}: greedy tokens differ from the plain run")
    if draft.startswith("bf16") and totals["accepted"] != totals["drafted"]:
        fail(f"{tag}: the draft equals the verify, yet only "
             f"{totals['accepted']} of {totals['drafted']} drafts were "
             "accepted")
    if not draft.startswith("bf16") and not \
            0 < totals["accepted"] < totals["drafted"]:
        fail(f"{tag}: {totals['accepted']} of {totals['drafted']} drafts "
             "accepted: the run did not exercise a partial rollback")
    if launches != want["launches"]:
        fail(f"{tag}: launches {launches}, expected {want['launches']}")
    return {tag: res}


def local_phase():
    """[local] gemma3-12b at its published size: 48 layers, 5 local
    (window 1024) : 1 global, head_dim 256. One prompt of 1040 tokens rolls
    its local caches at prefill, and decode wraps them; kernel B serves
    the 8 global layers' prefill at hd 256. ``bf16:dense:hopper`` dense
    and paged against a torch-backend run, and a speculative session with
    a bf16 draft at k = 4 whose tokens must equal the dense run's. The
    chunked (local-layer) attention takes the whole prompt as one chunk:
    the reference's chunks must divide the prompt, and 1040 is no multiple
    of its default 1024."""
    import torch
    t0 = time.perf_counter()
    cfg, params = block_model(LOCAL_ARCH)
    rt_kw = dict(chunk_q=LOCAL_MAX_LEN, chunk_kv=LOCAL_MAX_LEN)
    requests = block_requests(cfg, LOCAL_PROMPT_LENS)
    results, dense = serve_block(LOCAL_ARCH, cfg, params, requests,
                                 LOCAL_MAX_LEN, rt_kw, ("bf16",),
                                 LOCAL_PAGES)
    results.update(spec_block(LOCAL_ARCH, cfg, params, requests,
                              LOCAL_MAX_LEN, rt_kw, "bf16:dense:hopper",
                              LOCAL_SPEC_K, dense))
    del params
    torch.cuda.empty_cache()
    print(f"[{LOCAL_ARCH}] phase took {time.perf_counter() - t0:.1f}s",
          flush=True)
    return results


SSM_ARCH, HYBRID_ARCH = "rwkv6-3b", "zamba2-1.2b"
# rwkv6-3b (scan chunk 128): one prompt of two chunks, so that the state
# carries across chunks at prefill, the others as in the llama3 runs
SSM_PROMPT_LENS = (256, 77, 128, 77, 128, 77, 128, 77)
# its paged pool pools nothing (no attention layer); the pager still
# accounts 17 + 3 x 9 pages at the peak
SSM_PAGES = 48
# zamba2-1.2b (scan chunk 256): one prompt of two chunks
HYBRID_PROMPT_LENS = (512, 77, 128, 77, 128, 77, 128, 77)
HYBRID_MAX_LEN = 640
# the six shared-attention caches pooled: 33 + 3 x 9 pages at the peak
HYBRID_PAGES = 64
HYBRID_SPEC_K = 4


def handoff_block(arch, cfg, params, requests, max_len, dense) -> dict:
    """``export_slot`` of slots 0 and 1 after the first decode step, then
    ``import_slot`` of both in the other order, so each request resumes in
    the other slot with its state moved whole: the greedy tokens must
    equal the plain run ``dense``'s."""
    from repro_torch.core import execution as ex
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.runtime.serve_loop import ServeSession, export_nbytes
    tag = f"{arch} handoff"
    sess = ServeSession(params, cfg, batch_slots=SLOTS, max_len=max_len,
                        rt=RuntimeCfg(use_pallas=True),
                        policy=ex.parse_policy("bf16:dense:hopper"),
                        device="cuda")
    moved = {}

    def swap(s):
        exports = [s.export_slot(i) for i in (0, 1)]
        moved["bytes"] = sum(export_nbytes(e) for e in exports)
        for e in reversed(exports):
            s.import_slot(e)
        moved["slots"] = [next(i for i, r in enumerate(s.slots)
                               if r is e.request) for e in exports]

    zero_launch_counts()
    run = drive(sess, requests(), after_first_decode=swap)
    launches = launch_counts()
    del sess
    same = sum(run["outs"][u] == dense["outs"][u] for u in dense["outs"])
    print(f"[{tag}] slots 0 and 1 exported after the first decode step "
          f"({moved['bytes'] / 2**20:.1f} MiB) and imported into slots "
          f"{moved['slots']}; greedy tokens equal to the plain run for "
          f"{same}/{N_REQUESTS} requests", flush=True)
    if same != N_REQUESTS or moved["slots"] != [1, 0]:
        fail(f"{tag}: the handed-off requests differ from the plain run")
    return {tag: {"policy": tag, "tokens_equal_plain": same,
                  "handoff_bytes": moved["bytes"], "launches": launches}}


def ssm_phase():
    """[ssm] rwkv6-3b at its published size: 32 rwkv6 layers (d 2560, 40
    heads of 64), 9 GEMMs on kernel A per layer and step and none on B;
    ``bf16:dense:hopper`` dense and paged (the paged cache pools nothing:
    bit-equal to dense) and ``fp8:dense:hopper``, each against a
    torch-backend run, with the sublayer diagnosis printed beside."""
    import torch
    t0 = time.perf_counter()
    cfg, params = block_model(SSM_ARCH)
    results, _ = serve_block(SSM_ARCH, cfg, params,
                             block_requests(cfg, SSM_PROMPT_LENS), MAX_LEN,
                             {}, ("bf16", "fp8"), SSM_PAGES)
    del params
    torch.cuda.empty_cache()
    print(f"[{SSM_ARCH}] phase took {time.perf_counter() - t0:.1f}s",
          flush=True)
    return results


def hybrid_phase():
    """[hybrid] zamba2-1.2b at its published size: 38 mamba2 layers (6 x 6
    and a tail of 2) and 6 invocations of the shared attention block;
    ``bf16:dense:hopper`` dense and paged (the six shared-attention caches
    pooled), each against a torch-backend run; ``bf16:sparse24:hopper``
    (kernel D at N = 64 among its shapes); a speculative session with an
    ``fp8:dense:hopper`` draft at k = 4, whose rejected steps roll the
    recurrent states back; and a slot handoff mid-decode."""
    import torch
    t0 = time.perf_counter()
    cfg, params = block_model(HYBRID_ARCH)
    requests = block_requests(cfg, HYBRID_PROMPT_LENS)
    results, dense = serve_block(HYBRID_ARCH, cfg, params, requests,
                                 HYBRID_MAX_LEN, {}, ("bf16",), HYBRID_PAGES)
    tag = f"{HYBRID_ARCH} bf16:sparse24:hopper"
    results[tag], packed = serve_sparse24(params, cfg, requests,
                                          HYBRID_MAX_LEN, tag)
    del packed
    torch.cuda.empty_cache()
    results.update(spec_block(HYBRID_ARCH, cfg, params, requests,
                              HYBRID_MAX_LEN, {}, "fp8:dense:hopper",
                              HYBRID_SPEC_K, dense))
    results.update(handoff_block(HYBRID_ARCH, cfg, params, requests,
                                 HYBRID_MAX_LEN, dense))
    del params
    torch.cuda.empty_cache()
    print(f"[{HYBRID_ARCH}] phase took {time.perf_counter() - t0:.1f}s",
          flush=True)
    return results


# ---------------------------------------------------------------------------
# [train]: llama3-8b at full width, 8 layers, through make_train_step
# ---------------------------------------------------------------------------

TRAIN_ARCH, TRAIN_LAYERS = "llama3-8b", 8
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 512, 3
# hopper against the torch backend at step 0, from one init and one batch.
# The two forwards differ in f32 summation order and so in the bf16
# rounding of activations (one ulp, 2^-8 of an element); the loss is a mean
# over 2048 tokens and each grad norm a norm over a whole leaf, which
# average those: bf16 2e-3 of the loss and 2e-2 of each leaf's grad norm.
# Under fp8 a one-ulp move can cross an e4m3 rounding boundary (2^-4 of an
# element, LOGIT_TOL's reason): 1e-2 of the loss at each step. At a random
# init the loss sits near ln V whatever the GEMMs compute, so it cannot
# tell an fp8 forward from a bf16 one; the fp8 arm is held by its step-0
# forward sublayer by sublayer instead (fp8_forward_check). fp8 grad
# norms are printed, not held: the reference's dynamic fp8 GEMM is
# differentiated through its unscaled e4m3 casts, so each leaf's gradient
# is a sparse set of values on e4m3's subnormal grid (layer 0's w_gate
# keeps a norm of 0.006 where bf16 gives 0.70), and what survives of a
# leaf turns on the last bits of the activations (gaps up to 1.8x
# measured between the backends on the H100).
TRAIN_LOSS_TOL = {"bf16": 2e-3, "fp8": 1e-2}
TRAIN_GRAD_TOL = {"bf16": 2e-2}
# fp8:dense:hopper's step-0 forward against fp8:dense:torch's, sublayer by
# sublayer on one input (fp8_forward_check), as the RMS of the gap over the
# RMS of the torch output. Both quantize the same bf16 input to e4m3 and
# the first GEMMs of a sublayer see the same e4m3 operands; they part where
# a one-ulp bf16 difference in a first GEMM's output moves an element of
# the next GEMM's input across an e4m3 rounding boundary (about 1 in 16 of
# the elements that differ, each by one e4m3 step, 2^-4). A bf16 sublayer
# differs from an fp8 one by every operand's e4m3 rounding (RMS ~2^-4/3^0.5
# of each element), so a bf16 forward in the fp8 arm's place must fail the
# gate: the check runs that control and fails if it passes. End to end the
# logits cannot hold such a gate: over 8 layers the backends' flips
# compound (the two fp8 runs' logits part by 6.9e-2, the control's by
# 1.02e-1; PERF.md).
TRAIN_FP8_TOL = 2e-2
# kernel A at the training shapes (M = B·S = 2048): label, K, N, type, out
TRAIN_GEMM_SHAPES = (
    ("train_q_o", 4096, 4096, "bf16", "bfloat16"),
    ("train_k_v", 4096, 1024, "bf16", "bfloat16"),
    ("train_gate_up", 4096, 14336, "bf16", "bfloat16"),
    ("train_down", 14336, 4096, "bf16", "bfloat16"),
    ("train_head_chunk", 4096, 128256, "bf16", "float32"),
    ("train_gate_up", 4096, 14336, "e4m3", "float32"),
)


def train_cfg():
    import dataclasses
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(TRAIN_ARCH),
                               num_layers=TRAIN_LAYERS)


def train_launches_expected(cfg, spec: str, steps: int,
                            seq: int = TRAIN_S) -> dict:
    """Kernel launches of ``steps`` train steps of ``cfg`` under ``spec``,
    from the code: {"launches": by kernel, "batched": kernel A's
    expert-batched launches among them}. Each layer's linears by block
    kind (``GEMMS_PER_KIND``: 7 for an attention layer, a MoE layer's 3
    FFN GEMMs being expert-batched launches, one for all experts, and its
    shared expert 3 more; 6 per mamba2 layer; 9 per rwkv6 layer). The
    stack's super-layers and each CE chunk are checkpointed (``remat``
    "full" or "dots"), so each of their launches runs once forward and
    once more in backward; the hybrid tail runs outside them, once.
    Under ``hopper`` in bf16 the backward of each linear (each expert-
    batched one too) is two more launches of kernel A, dX and dW, once per
    step; the fp8 and 2:4 entries differentiate the torch reference. The
    LM head once per CE chunk, on kernel A in bf16 whatever the policy;
    its f32 cotangent takes the f32 reference's products in backward.
    Under ``hopper_sparse24`` every linear is kernel D, a MoE layer's
    experts one launch each."""
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.runtime import train_loop as tl
    remat = 2 if cfg.remat in ("full", "dots") else 1
    n_stack = cfg.num_superlayers * len(cfg.superlayer_pattern)
    precision, _, backend = spec.split(":")
    grads = 2 if (backend, precision) == ("hopper", "bf16") else 0
    linears = batched = 0
    for i, kind in enumerate(layer_kinds(cfg)):
        runs = remat if i < n_stack else 1
        n = GEMMS_PER_KIND.get(kind, 7)
        if kind == "attn_moe":
            n += 3 * bool(cfg.moe_shared_expert)
            if backend == "hopper_sparse24":
                n += 3 * (cfg.num_experts - 1)
            else:
                batched += 3 * (runs + grads)
        linears += n * (runs + grads)
    head = 2 * (seq // min(tl.CE_CHUNK, seq))
    want = {"gemm": 0, "flash_attention": 0, "paged_attention": 0,
            "sparse24_gemm": 0, "block24_gemm": 0}
    if backend == "hopper":
        want["gemm"] = (linears + head) * steps
    elif backend == "hopper_sparse24":
        want["sparse24_gemm"] = linears * steps
        want["gemm"] = head * steps
    return {"launches": want,
            "batched": batched * steps if backend == "hopper" else 0}


def state_bytes(state) -> dict:
    return {"params": tree_bytes(state.params),
            "master": tree_bytes(state.opt.master),
            "mu": tree_bytes(state.opt.mu), "nu": tree_bytes(state.opt.nu)}


def leaf_grad_norms(cfg, rt, policy, params, batch):
    """Step-0 loss and the f32 norm of each leaf's gradient, in leaf
    order (the grads freed before returning)."""
    import torch
    from repro_torch.core import execution as ex
    from repro_torch.core import tree
    from repro_torch.runtime import train_loop as tl
    pcfg, prt = ex.apply_policy(cfg, rt, policy)
    (loss, _), grads = tl.value_and_grad(tl.make_loss_fn(pcfg, prt))(
        params, batch)
    norms = [float(torch.linalg.vector_norm(g.float()))
             for g in tree.leaves(grads)]
    return float(loss), norms, grads


def init_checksum(params) -> int:
    """The sum of every leaf's bits read as integers (int16 words of a
    bf16 leaf, int32 of an f32 one): equal for two draws of one init."""
    import torch
    from repro_torch.core import tree
    return sum(int(t.view(torch.int16 if t.element_size() == 2
                          else torch.int32).sum(dtype=torch.int64))
               for t in tree.leaves(params))


def train_arm(tag, cfg, draw, checksum, batches, steps, opt_cfg, rt,
              profile=False, label="train"):
    """``steps`` train steps under the policy ``tag`` from the init
    ``draw()`` makes, which must be the one the phase's checks ran on (its
    ``init_checksum`` equal to ``checksum``): the step-0 loss and per-leaf
    grad norms (a separate forward and backward before the steps), then
    the steps with every launch counter zeroed just before and read just
    after, each step timed by the host clock around work that ends in a
    device synchronise. Lines are printed under ``[label]``."""
    import torch
    from repro_torch.core import execution as ex
    from repro_torch.core import tree
    from repro_torch.runtime import train_loop as tl
    policy = ex.parse_policy(tag)
    params = draw()
    if init_checksum(params) != checksum:
        fail(f"{cfg.name} {tag}: the init drawn from the seed is not the "
             "one the checks ran on (its checksum differs)")
    loss0, norms, grads = leaf_grad_norms(cfg, rt, policy, params,
                                          batches[0])
    # an embeddings-input stack never reads its token table: its
    # gradient must be exactly zero, as jax.grad gives it
    embed_nonzero = int(torch.count_nonzero(grads["embed"])) \
        if cfg.input_mode == "embeddings" else None
    if tag == "bf16:dense:hopper_sparse24":
        # the repaired fault: the weight gets the masked gradient of the
        # 2:4-pruned weight (half of each group of four), not none
        g = grads["layers"][0]["mlp"]["w_gate"]
        nonzero = int((g != 0).sum())
        print(f"[{label}] {tag}: layer 0 w_gate gradient nonzero "
              f"{nonzero} of {g.numel()} (half: {g.numel() // 2})",
              flush=True)
        if nonzero != g.numel() // 2:
            fail(f"{tag}: w_gate's gradient is not the 2:4-masked one "
                 f"({nonzero} nonzero of {g.numel()})")
    del grads
    state = tl.init_state(params, opt_cfg)
    del params
    sb = state_bytes(state)
    print(f"[{label}] {cfg.name} {tag}: state {json.dumps(sb)} = "
          f"{sum(sb.values()) / 2**30:.2f} GiB before the first step "
          f"(grads {sb['params'] / 2**30:.2f} GiB more in a step; moments "
          f"{str(opt_cfg.moments_dtype).split('.')[-1]})", flush=True)
    step = tl.make_train_step(cfg, opt_cfg, rt, policy=policy)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    losses, auxes, times = [], [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i])
        loss = float(metrics["loss"])            # waits for the step
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        auxes.append(float(metrics["aux"]))
    launches = launch_counts()
    from repro_torch.kernels import fp8_matmul as fm
    types, batched = dict(fm.TYPE_LAUNCHES), fm.BATCHED_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    b, seq = batches[0]["labels"].shape
    want = train_launches_expected(cfg, tag, steps, seq)
    out = {"arch": cfg.name, "policy": tag, "losses": losses,
           "loss0": loss0, "aux": auxes,
           "grad_norms": norms, "step_ms": [1e3 * t for t in times],
           "launches": launches, "launches_expected": want["launches"],
           "expert_batched_launches": batched,
           "expert_batched_expected": want["batched"],
           "gemm_by_type": types, "peak_bytes": peak,
           "state_bytes": sum(sb.values()),
           "embed_grad_nonzero": embed_nonzero}
    # the median of the steps after the first (which takes the first
    # calls' set-up); a one-step arm has only the first
    later = sorted(out["step_ms"][1:] or out["step_ms"])
    half = len(later) // 2
    out["ms_per_step"] = later[half] if len(later) % 2 \
        else (later[half - 1] + later[half]) / 2
    out["tok_s"] = b * seq / (out["ms_per_step"] / 1e3)
    if profile:
        def one():
            nonlocal state
            state, m = step(state, batches[0])
            float(m["loss"])
        one()                                     # warm, unprofiled
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        gemms = ("gemm", "sparse24_gemm", "block24_gemm")
        ran = 0

        def profiled_step():
            nonlocal ran
            before = launch_counts()
            one()
            torch.cuda.synchronize()
            after = launch_counts()
            ran = sum(after[k] - before[k] for k in gemms)

        # complete: a record for every launch of kernels A, D and E
        got = traced(profiled_step, lambda ks: len(
            [e for e in ks if is_port_gemm(e.name)]) == ran, "a train step")
        if got is None:
            out["profile"] = {
                "step_ms_unprofiled": wall_ms,
                "device_busy_ms": "not measured: torch.profiler lost "
                                  "kernel records in every attempt"}
        else:
            kernels = got[1]
            spans = [(e.start, e.end, e.stream) for e in kernels]
            by_name = {}
            for e in kernels:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.end - e.start
            busy = busy_us(spans) / 1e3
            total = sum(by_name.values()) / 1e3
            gemm = sum(t for n, t in by_name.items()
                       if is_port_gemm(n)) / 1e3
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            out["profile"] = {
                "step_ms_unprofiled": wall_ms, "device_busy_ms": busy,
                "device_idle_share": 1.0 - busy / wall_ms,
                "kernels": len(spans), "kernel_a_ms": gemm,
                "kernel_a_share_of_device_time":
                    gemm / total if total else None,
                "top_kernels_ms": {short_name(n): t / 1e3 for n, t in top}}
    print(f"[{label}] {json.dumps(out)}", flush=True)
    if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)):
        fail(f"{tag}: non-finite loss {losses}")
    if launches != want["launches"] or batched != want["batched"]:
        fail(f"{tag}: launches {launches} ({batched} expert-batched), the "
             f"code implies {want}")
    del state
    torch.cuda.empty_cache()
    return out


def fp8_forward_check(cfg, rt, init, batch) -> dict:
    """The fp8 arm's step-0 forward (no grad) on ``batch``, teacher forced
    sublayer by sublayer: each layer's attention and MLP run under
    ``fp8:dense:hopper``, ``fp8:dense:torch`` and the control
    ``bf16:dense:torch`` on one input, the hopper output feeding on. Every
    hopper output is within TRAIN_FP8_TOL of the fp8 torch one and every
    control output beyond it. The end-to-end logits of the three policies
    are printed beside, not held: there the backends' rounding differences
    compound over the layers."""
    import torch
    from repro_torch.core import execution as ex
    from repro_torch.models import forward
    from repro_torch.models.attention import attention_block
    from repro_torch.models.layers import embed_tokens, rms_norm, swiglu_mlp
    tags = ("fp8:dense:torch", "fp8:dense:hopper", "bf16:dense:torch")
    sides = {t: ex.apply_policy(cfg, rt, ex.parse_policy(t)) for t in tags}

    def gaps(outs):
        ref = outs[tags[0]].float()
        return {t: float((outs[t].float() - ref).norm() / ref.norm())
                for t in tags[1:]}
    hop, ctrl = [], []
    with torch.no_grad():
        x = embed_tokens(batch["inputs"], init["embed"]).to(rt.act_dtype)
        for p in init["layers"]:
            for norm, fn in (
                    ("norm1", lambda h, c, r: attention_block(h, p["attn"],
                                                              c, r)),
                    ("norm2", lambda h, c, r: swiglu_mlp(h, p["mlp"], c, r))):
                h = rms_norm(x, p[norm], cfg.norm_eps)
                outs = {t: fn(h, *sides[t]) for t in tags}
                g = gaps(outs)
                hop.append(g[tags[1]])
                ctrl.append(g[tags[2]])
                x = x + outs[tags[1]]
        del outs
        e2e = gaps({t: forward(init, batch["inputs"], *sides[t])[0][
            ..., :cfg.vocab_size] for t in tags})
    torch.cuda.empty_cache()
    tol = TRAIN_FP8_TOL
    ok = max(hop) <= tol < min(ctrl)
    out = {"sublayers": len(hop), "hopper_worst": max(hop),
           "control_least": min(ctrl), "logits_end_to_end": e2e}
    print(f"[train] fp8 step-0 forward against fp8:dense:torch, teacher "
          f"forced over {len(hop)} sublayers (rel RMS gap): fp8:dense:hopper"
          f" worst {max(hop):.3e}, control bf16:dense:torch least "
          f"{min(ctrl):.3e} (tol {tol}: hopper within, control beyond) "
          f"{'ok' if ok else 'MISMATCH'}; end-to-end logits (not held): "
          f"hopper {e2e[tags[1]]:.3e}, control {e2e[tags[2]]:.3e}",
          flush=True)
    if not ok:
        fail("fp8:dense:hopper's forward: a sublayer beyond the tolerance "
             "of the torch backend's, or the gate cannot tell bf16 from fp8")
    return out


def norm_gaps(norms, ref_norms, held=None):
    """Each held leaf's grad-norm gap relative to ``ref_norms``' norm,
    floored at 1e-3 of the largest: under fp8 the reference's unscaled
    e4m3 cast of the cotangent flushes most of the q/k projections'
    gradient to zero, and what survives of such a leaf has no stable
    relative size."""
    floor = 1e-3 * max(ref_norms)
    return [abs(a - b) / max(b, floor)
            for i, (a, b) in enumerate(zip(norms, ref_norms))
            if held is None or held[i]]


def check_pair(tag, hop, ref, precision, held=None, aux=False, hard=True,
               label="train"):
    """``hop`` (the hopper arm) against ``ref`` (the torch backend's),
    from one init and the same batches: the loss of step 0 and of each
    step after it (with ``aux``, also each step's aux loss), and (bf16)
    the step-0 grad norm of each leaf ``held`` marks (default all). A
    mismatch fails the run, or with ``hard`` false is returned in "ok"
    for the caller's fallback."""
    rel = max(abs(a / b - 1) for a, b in zip(
        [hop["loss0"]] + hop["losses"], [ref["loss0"]] + ref["losses"]))
    aux_rel = max(abs(a / b - 1) for a, b in zip(hop["aux"], ref["aux"])) \
        if aux else 0.0
    gaps = norm_gaps(hop["grad_norms"], ref["grad_norms"], held)
    worst = max(gaps)
    grad_tol = TRAIN_GRAD_TOL.get(precision)
    loss_ok = max(rel, aux_rel) <= TRAIN_LOSS_TOL[precision]
    grad_ok = grad_tol is None or worst <= grad_tol
    ok = loss_ok and grad_ok
    print(f"[{label}] {tag} vs torch backend: step-0 loss "
          f"{hop['loss0']:.6f} / {ref['loss0']:.6f}, losses {hop['losses']}"
          f" / {ref['losses']} (largest rel {rel:.2e}"
          + (f"; aux {hop['aux']} / {ref['aux']}, largest rel "
             f"{aux_rel:.2e}" if aux else "")
          + f", tol {TRAIN_LOSS_TOL[precision]:g}); largest per-leaf step-0 "
          f"grad-norm gap {worst:.2e} over {len(gaps)} leaves (tol "
          f"{grad_tol if grad_tol is not None else 'none: printed only'}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if hard and not ok:
        fail(f"{tag}: against the torch backend: loss rel {rel:.2e}, aux "
             f"rel {aux_rel:.2e}, grad-norm gap {worst:.2e}")
    return {"loss0_rel": rel, "aux_rel": aux_rel, "grad_norm_gap": worst,
            "held_leaves": len(gaps), "loss_ok": loss_ok, "grad_ok": grad_ok}


def train_gemm_row(label, M, K, N, kind, out, gen, tag="train-gemm"):
    """Kernel A at one training shape (M = B·S rows): checked against its
    plain version and for a bit-equal repeat, timed with its bound and the
    library call; the row is printed under ``[tag]``."""
    import torch
    from repro_torch.kernels import fp8_matmul as fm
    out_dtype = getattr(torch, out)
    x, w = gemm_inputs(M, K, N, kind, gen)
    got = fm.fp8_matmul(x, w, out_dtype)
    again = fm.fp8_matmul(x, w, out_dtype)
    want = fm.fp8_matmul_plain(x, w, out_dtype)
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(want.float().abs().max().item(), 1e-30)
    same = bit_equal(got, again)
    if not (rel <= GEMM_REL_TOL[out] and same
            and bool(torch.isfinite(got).all())):
        fail(f"GEMM {label} {kind}->{out} at M={M}: rel {rel:.2e}, "
             f"repeat bit-equal {same}")
    del got, again, want
    ms, copies, timer = cold_ms(
        lambda a, b: fm.fp8_matmul(a, b, out_dtype), (x, w), 10)
    plain = time_ms(lambda: fm.fp8_matmul_plain(x, w, out_dtype), 2)
    if kind == "bf16":
        lib, _, lib_timer = cold_ms(torch.matmul, (x, w), 10)
        note = "torch.matmul"
    else:
        lib, note, lib_timer = scaled_mm_ms(x, w, out_dtype, 10)
    eb, ob = (2 if kind == "bf16" else 1), (4 if out == "float32" else 2)
    bms, by = bound_ms(M * K * eb + K * N * eb + M * N * ob,
                       2.0 * M * N * K, kind)
    row = {"label": label, "M": M, "K": K, "N": N, "type": kind,
           "out": out, "max_abs_err": err, "rel": rel, "ms": ms,
           "plain_ms": plain, "library_ms": lib, "library_note": note,
           "bound_ms": bms, "timer": timer, "library_timer": lib_timer,
           "bound_by": by, "plan": plan_note(M, N, K, "gemm"),
           "operand_copies": copies}
    print(f"[{tag}] {json.dumps(row)}", flush=True)
    return row


def train_gemm_rows():
    """Kernel A at the training shapes, and kernel D at the gate/up shape
    of the prune+pack arm: checked against the plain versions, timed with
    their bounds and the library call."""
    import torch
    from repro_torch.core import sparsity as sp
    from repro_torch.kernels import sparse24_matmul as sm
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    M = TRAIN_B * TRAIN_S
    rows = [train_gemm_row(label, M, K, N, kind, out, gen)
            for label, K, N, kind, out in TRAIN_GEMM_SHAPES]
    # kernel D: the prune+pack arm's gate/up, values packed from the
    # pruned weight as hopper_sparse24.dense packs them per call
    K, N = 4096, 14336
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device="cuda")
         * K ** -0.5).to(torch.bfloat16)
    t0 = time.perf_counter()
    values, meta = sp.pack_24(sp.prune_24(w))
    torch.cuda.synchronize()
    pack_ms = 1e3 * (time.perf_counter() - t0)
    got = sm.sparse24_matmul(x, values, meta, torch.bfloat16)
    want = sm.sparse24_matmul_plain(x, values, meta, torch.bfloat16)
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(want.float().abs().max().item(), 1e-30)
    if rel > GEMM_REL_TOL["bfloat16"]:
        fail(f"packed GEMM train_gate_up at M={M}: rel {rel:.2e}")
    ms, copies, timer = cold_ms(
        lambda a, v, m: sm.sparse24_matmul(a, v, m, torch.bfloat16),
        (x, values, meta), 10)
    plain = time_ms(lambda: sm.sparse24_matmul_plain(x, values, meta,
                                                     torch.bfloat16), 2)
    w_dense = sp.unpack_24(values, meta)
    lib, _, lib_timer = cold_ms(torch.matmul, (x, w_dense), 10)
    bms, by = bound_ms(M * K * 2 + (K // 2) * N * 2 + (K // 8) * N
                       + M * N * 2, 2.0 * M * N * (K // 2), "bf16")
    row = {"label": "train_gate_up", "M": M, "K": K, "N": N,
           "values": "bf16", "out": "bfloat16", "max_abs_err": err,
           "ms": ms, "plain_ms": plain, "library_ms": lib,
           "timer": timer, "library_timer": lib_timer,
           "library_note": "torch.matmul on the unpacked bf16 weight",
           "bound_ms": bms, "bound_by": by,
           "plan": plan_note(M, N, K, "sparse24"), "operand_copies": copies,
           "prune_pack_ms_first_call": pack_ms}
    print(f"[train-sparse24] {json.dumps(row)}", flush=True)
    return rows, row


def train_grad_guard():
    """On the card, autograd through a kernel entry point raises (as
    ``jax.grad`` through a ``pallas_call`` does), and so does a train step
    whose attention runs on kernel B (``rt.use_pallas``)."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.core import sparsity as sp
    from repro_torch.kernels import fp8_matmul as fm
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sparse24_matmul as sm
    from repro_torch.models import init_params
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop as tl
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)

    def t(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    x, w = t(16, 256), t(256, 128)
    vals, meta = sp.pack_24(sp.prune_24(w))
    q = t(1, 128, 4, 64)
    calls = {
        "A fp8_matmul": lambda g: fm.fp8_matmul(x.requires_grad_(g), w),
        "A fp8_matmul_batched": lambda g: fm.fp8_matmul_batched(
            x[None].detach().requires_grad_(g), w[None]),
        "B flash_attention": lambda g: ops.flash_attention(
            q.requires_grad_(g), q[:, :, :2].detach(), q[:, :, :2].detach()),
        "C paged_flash_decode": lambda g: pa.paged_flash_decode(
            t(2, 4, 64).requires_grad_(g), t(3, 16, 2, 64), t(3, 16, 2, 64),
            torch.tensor([[0], [1]], dtype=torch.int32, device="cuda"),
            torch.tensor([5, 16], dtype=torch.int32, device="cuda")),
        "D sparse24_matmul": lambda g: sm.sparse24_matmul(
            x.detach().requires_grad_(g), vals, meta),
        "E block24_matmul": lambda g: ops.block24_matmul(
            x.detach().requires_grad_(g), w[:128].contiguous(), (0,),
            block=128)}
    for name, call in calls.items():
        try:
            call(True)
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            fail(f"{name}: autograd through the kernel entry point was "
                 "not refused on the card")
        with torch.no_grad():
            if call(True).grad_fn is not None:
                fail(f"{name}: forward under no_grad built a graph")
    cfg = get_reduced(TRAIN_ARCH)
    opt = adamw.AdamWConfig(total_steps=10, warmup_steps=2)
    state = tl.init_state(init_params(cfg, gen, device="cuda"), opt)
    step = tl.make_train_step(cfg, opt, RuntimeCfg(use_pallas=True))
    batch = {"inputs": torch.randint(0, cfg.vocab_size, (2, 64),
                                     device="cuda", generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (2, 64),
                                     device="cuda", generator=gen)}
    try:
        step(state, batch)
    except RuntimeError as e:
        if "flash_attention has no backward" not in str(e):
            raise
    else:
        fail("a train step with rt.use_pallas=True was not refused")
    print(f"[train] grad guard on the card: {len(calls)} kernel entry "
          "points refuse autograd (A, A batched, B, C, D, E) and run under "
          "no_grad; a train step with rt.use_pallas=True raises", flush=True)


def train_cli():
    """``launch/train.py --reduced --device cuda --backend hopper``: six
    steps straight against three, a checkpoint and three resumed, and
    against a supervised run that saves every two steps, fails at step 3
    and resumes from its periodic checkpoint; the states bit-equal under
    deterministic algorithms."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.train import main as train_main
    base = ROOT / "build" / "train_cli"
    shutil.rmtree(base, ignore_errors=True)
    common = ["--arch", TRAIN_ARCH, "--reduced", "--device", "cuda",
              "--backend", "hopper", "--batch", "4", "--seq", "128",
              "--log-every", "100", "--checkpoint-every", "100"]
    torch.use_deterministic_algorithms(True)
    t0 = time.perf_counter()
    try:
        for argv in (["--steps", "6", "--checkpoint-dir", str(base / "a")],
                     ["--steps", "3", "--checkpoint-dir", str(base / "b")],
                     ["--steps", "6", "--checkpoint-dir", str(base / "b"),
                      "--resume"]):
            if train_main(common + argv) != 0:
                fail(f"train CLI {argv} did not finish")
        rc = train_main(common + ["--steps", "6", "--checkpoint-dir",
                                  str(base / "c"), "--checkpoint-every", "2",
                                  "--fail-at-step", "3", "--supervise",
                                  "--max-restarts", "1"])
    finally:
        torch.use_deterministic_algorithms(False)

    def leaves(d):
        path = d / f"step_{CheckpointManager(str(d)).latest_step()}"
        n = len(list(path.glob("arr_*.npy")))
        return [np.load(path / f"arr_{i}.npy") for i in range(n)]

    def same(x, y):
        return len(x) == len(y) and all(np.array_equal(p, q)
                                        for p, q in zip(x, y))
    a, b, c = leaves(base / "a"), leaves(base / "b"), leaves(base / "c")
    last = CheckpointManager(str(base / "c")).latest_step()
    print(f"[train] CLI: 6 steps straight vs 3 + checkpoint + resume 3: "
          f"{len(a)} state leaves bit-equal={same(a, b)}; vs supervised "
          f"restart after --fail-at-step 3 from the periodic checkpoint: rc "
          f"{rc}, last checkpoint step {last}, bit-equal={same(a, c)} "
          f"(deterministic algorithms); CLI arm "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    if not same(a, b):
        fail("train CLI resume is not bitwise")
    if rc != 0 or last != 6 or not same(a, c):
        fail("the supervised restart did not finish the run bit-equal")
    shutil.rmtree(base, ignore_errors=True)


def fp8_linear_check():
    """One delayed-scaling ``fp8_linear`` forward and backward at the
    gate/up shape (M = 2048) with its forward on kernel A, against the
    torch backend's plain version: the forward within GEMM_REL_TOL, the
    backward (the same E5M2 torch code on the same fp8 operands)
    bit-equal."""
    import torch
    from repro_torch.core import fp8 as fp8lib
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    M, K, N = TRAIN_B * TRAIN_S, 4096, 14336
    x0 = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    w0 = (torch.randn((K, N), generator=gen, device="cuda")
          * K ** -0.5).to(torch.bfloat16)
    g = torch.randn((M, N), generator=gen, device="cuda").to(torch.bfloat16)
    state = fp8lib.init_fp8_state(["gate"], device="cuda")
    collect = {}
    fp8lib.fp8_linear(x0, w0, state, "gate", collect=collect)
    state = fp8lib.fold_amaxes(state, collect)     # scales from step 0
    outs = {}
    for backend in ("hopper", "torch"):
        zero_launch_counts()
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        y = fp8lib.fp8_linear(x, w, state, "gate", backend=backend)
        dx, dw = torch.autograd.grad(y, (x, w), g)
        outs[backend] = (y.detach(), dx, dw, launch_counts()["gemm"])
    (y, dx, dw, n), (ry, rdx, rdw, rn) = outs["hopper"], outs["torch"]
    err = (y.float() - ry.float()).abs().max().item()
    rel = err / ry.float().abs().max().item()
    same = bit_equal(dx, rdx) and bit_equal(dw, rdw)
    ok = rel <= GEMM_REL_TOL["bfloat16"] and same and n == 1 and rn == 0 \
        and dx.dtype == dw.dtype == torch.bfloat16
    print(f"[train] fp8_linear M={M} K={K} N={N} (delayed scales "
          f"x {float(state['gate/x'].scale):.4g}, w "
          f"{float(state['gate/w'].scale):.4g}): forward on kernel A "
          f"({n} launch) rel {rel:.2e} to the torch backend; dx, dw bf16 "
          f"bit-equal={same} {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("fp8_linear disagrees with its plain version")


def train_phase():
    """llama3-8b at full width, 8 layers, B=4, S=512, bf16 weights from a
    seeded generator on the card, SyntheticLM batches: dense, fp8 and 2:4
    arms, the delayed-scaling linear, the CLI and the grad guard."""
    import torch
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.optim import adamw
    t_phase = time.perf_counter()
    cfg = train_cfg()

    def draw():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        return init_params(cfg, gen, device="cuda")
    init = draw()
    n_params = sum(t.numel() for t in tree.leaves(init))
    checksum = init_checksum(init)
    del init
    print(f"[train] {cfg.name}: {cfg.num_layers} layers (depth cut from "
          f"32), d_model {cfg.d_model}, d_ff {cfg.d_ff}, heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads}, vocab {cfg.vocab_size}; "
          f"{n_params / 1e9:.2f} B params; B={TRAIN_B} S={TRAIN_S}, "
          f"remat {cfg.remat}", flush=True)
    data = SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=SEED)
    batches = [{k: torch.from_numpy(v).to("cuda")
                for k, v in data.batch_at(i).items()}
               for i in range(TRAIN_STEPS)]
    rt = RuntimeCfg()
    opt_cfg = adamw.AdamWConfig(total_steps=1000, warmup_steps=20)
    rows, drow = train_gemm_rows()
    arms = {}
    for tag, steps, profile in (
            ("bf16:dense:hopper", TRAIN_STEPS, True),
            ("bf16:dense:torch", TRAIN_STEPS, False),
            ("fp8:dense:hopper", TRAIN_STEPS, False),
            ("fp8:dense:torch", TRAIN_STEPS, False),
            ("bf16:sparse24:hopper", 1, False),
            ("bf16:dense:hopper_sparse24", 1, False)):
        arms[tag] = train_arm(tag, cfg, draw, checksum, batches, steps,
                              opt_cfg, rt, profile)
    gaps = {"bf16": check_pair("bf16:dense:hopper",
                               arms["bf16:dense:hopper"],
                               arms["bf16:dense:torch"], "bf16"),
            "fp8": check_pair("fp8:dense:hopper", arms["fp8:dense:hopper"],
                              arms["fp8:dense:torch"], "fp8")}
    fp8_types = arms["fp8:dense:hopper"]["gemm_by_type"]
    if fp8_types["e4m3"] != 2 * 7 * cfg.num_layers * TRAIN_STEPS:
        fail(f"fp8:dense:hopper: e4m3 launches {fp8_types}")
    gaps["fp8"]["forward"] = fp8_forward_check(cfg, rt, draw(), batches[0])
    torch.cuda.empty_cache()
    fp8_linear_check()
    train_cli()
    train_grad_guard()
    summary = {tag: {k: a[k] for k in ("ms_per_step", "tok_s", "peak_bytes",
                                       "state_bytes", "launches")}
               for tag, a in arms.items()}
    summary["bf16:dense:hopper"]["profile"] = \
        arms["bf16:dense:hopper"]["profile"]
    print(f"[train-summary] {json.dumps({'arms': summary, 'step0': gaps})}",
          flush=True)
    print(f"[train] phase {time.perf_counter() - t_phase:.1f}s", flush=True)
    results = {f"train {tag}": {"launches": a["launches"]}
               for tag, a in arms.items()}
    return results, rows, drow, summary


# ---------------------------------------------------------------------------
# [train-blocks]: training the MoE, hybrid and rwkv6 block kinds
# ---------------------------------------------------------------------------

# (arch, layers kept or None for the whole stack, B, S): granite and rwkv6
# cut in depth as [train] cuts llama3-8b; zamba2 whole, since its hybrid
# tail only exists at full depth; gemma3-12b one 5 local : 1 global
# super-layer at B=1, S=2048 (the others' 2048 tokens), so that its local
# layers' window of 1024 masks; musicgen-medium whole (1.82 B params);
# llama4-scout one of its 48 layers (4.27 B: the expert stacks 2.01 B, the
# token table and the head 1.03 B each); chameleon-34b one of its 48
# (1.77 B: the layer 0.69 B, the token table and the head 0.54 B each),
# its embeddings input as musicgen's
TRAIN_BLOCKS = (("granite-moe-3b-a800m", 8, 4, 512),
                ("zamba2-1.2b", None, 4, 512), ("rwkv6-3b", 8, 4, 512),
                ("gemma3-12b", 6, 1, 2048), ("musicgen-medium", None, 4, 512),
                ("llama4-scout-17b-a16e", 1, 4, 512),
                ("chameleon-34b", 1, 4, 512))
TRAIN_BLOCK_ARMS = ("bf16:dense:hopper", "bf16:dense:torch")
# AdamW's moments in bf16 (the reference's own ``moments_dtype`` option)
# where f32 ones do not fit on the card beside the rest of a step:
# llama4-scout's 4.27 B params take 8.5 GB as bf16 weights, 17.1 GB as f32
# masters and would take 34.2 GB as f32 moments
TRAIN_BLOCK_BF16_MOMENTS = ("llama4-scout-17b-a16e",)
# kernel A at the dense stacks' new training shapes, M = B·S = 2048 rows:
# (label, K, N)
TRAIN_BLOCK_GEMM_SHAPES = {
    "gemma3-12b": (("gemma3_train_q", 3840, 4096),
                   ("gemma3_train_k_v", 3840, 2048),
                   ("gemma3_train_gate_up", 3840, 15360)),
    "musicgen-medium": (("musicgen_train_qkvo", 1536, 1536),
                        ("musicgen_train_gate_up", 1536, 6144)),
    "chameleon-34b": (("chameleon_train_qo", 8192, 8192),
                      ("chameleon_train_k_v", 8192, 1024),
                      ("chameleon_train_gate_up", 8192, 22016),
                      ("chameleon_train_down", 22016, 8192))}


def train_bytes(cfg, opt_cfg) -> dict:
    """``state_bytes`` of the state ``init_state`` makes for ``cfg`` under
    ``opt_cfg``, reckoned from shapes alone (``init_state`` of a ``meta``
    params tree: nothing is allocated)."""
    from repro_torch.models.transformer import params_shape
    from repro_torch.runtime import train_loop as tl
    return state_bytes(tl.state_shape(cfg, opt_cfg, params_shape(cfg)))


def train_peak_reckoned(cfg, opt_cfg) -> dict:
    """A train step's peak bytes, reckoned before it runs: the state
    (``train_bytes``), one gradient per param in its dtype, and AdamW's
    f32 temporaries over the largest leaf (``adamw.apply`` updates a leaf
    at a time: the f32 gradient, two products at once and, where the
    moments are not f32 already, the f32 copies of both moments)."""
    import torch
    from repro_torch.core import tree
    from repro_torch.models.transformer import params_shape
    sb = train_bytes(cfg, opt_cfg)
    largest = max(t.numel() for t in tree.leaves(params_shape(cfg)))
    temps = 3 if opt_cfg.moments_dtype == torch.float32 else 5
    out = {"state": sum(sb.values()), "grads": sb["params"],
           "adamw_f32_temporaries": temps * 4 * largest}
    out["total"] = sum(out.values())
    return out


def train_batches(cfg, B, S) -> list:
    """TRAIN_STEPS batches of B sequences of S tokens on the card:
    ``SyntheticLM``'s tokens and labels; an embeddings-input stack
    (musicgen) takes seeded normal (B, S, d) f32 frames, made on the card,
    as its inputs in place of the tokens, as ``tests/torch_train_parity.
    batches`` makes them on the CPU."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    data = SyntheticLM(cfg.vocab_size, S, B, seed=SEED)
    out = [{k: torch.from_numpy(v).to("cuda")
            for k, v in data.batch_at(i).items()}
           for i in range(TRAIN_STEPS)]
    if cfg.input_mode == "embeddings":
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        for batch in out:
            batch["inputs"] = torch.randn((B, S, cfg.d_model), generator=gen,
                                          device="cuda")
    return out


def train_expert_rows(cfg, tokens):
    """``registry.hopper_experts`` (kernel A's expert-batched launch) at
    the expert shapes of a training step of ``tokens`` tokens, forward and
    backward under autograd, against the ``torch`` backend's per-expert path
    (autograd through the f32 reference): the output and both operand
    gradients within GEMM_REL_TOL, three launches (the forward, and dX and
    dW in backward), a bit-equal repeat. Timed: the backward (two batched
    launches and the operands' transposes) per call, by CUDA events with
    the host's gaps in; at the gate/up shape (the kernels line's row) also
    the kernel with its bound and ``torch.bmm``."""
    import torch
    from repro_torch.core import execution as ex
    from repro_torch.kernels import fp8_matmul as fm
    from repro_torch.kernels import registry
    from repro_torch.models import moe
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    gs = min(cfg.moe_group_size, tokens)
    E = cfg.num_experts
    M = tokens // gs * moe.capacity(cfg, gs)
    plain_pol = ex.parse_policy("bf16:dense:torch")
    bf16 = torch.bfloat16
    rows = []
    for label, K, N in (("train_moe_gate_up", cfg.d_model, cfg.d_ff),
                        ("train_moe_down", cfg.d_ff, cfg.d_model)):
        x = torch.randn((E, M, K), generator=gen, device="cuda").to(bf16)
        w = (torch.randn((E, K, N), generator=gen, device="cuda")
             * K ** -0.5).to(bf16)
        g = torch.randn((E, M, N), generator=gen, device="cuda").to(bf16)
        xh, wh = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        before = fm.BATCHED_LAUNCHES
        out = registry.hopper_experts(xh, wh)
        dx, dw = torch.autograd.grad(out, (xh, wh), g, retain_graph=True)
        launched = fm.BATCHED_LAUNCHES - before
        with torch.no_grad():
            again = registry.hopper_experts(x, w)
        xp, wp = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        ref = ex.matmul_experts(xp, wp, plain_pol)
        rdx, rdw = torch.autograd.grad(ref, (xp, wp), g)
        rels, errs = {}, {}
        for name, a, b in (("out", out, ref), ("dx", dx, rdx),
                           ("dw", dw, rdw)):
            errs[name] = (a.float() - b.float()).abs().max().item()
            rels[name] = errs[name] / max(b.float().abs().max().item(), 1e-30)
        same = bit_equal(out.detach(), again)
        ok = launched == 3 and same and bool(torch.isfinite(out).all()) \
            and max(rels.values()) <= GEMM_REL_TOL["bfloat16"]
        plan = plan_note(M, N, K, "gemm", E)
        print(f"[train-blocks] hopper_experts {label} E={E} M={M} K={K} "
              f"N={N} bf16 under autograd against the torch backend's "
              f"per-expert path: rel out {rels['out']:.2e}, dx "
              f"{rels['dx']:.2e}, dw {rels['dw']:.2e} (tol "
              f"{GEMM_REL_TOL['bfloat16']}); {launched} launches forward "
              f"and backward; repeat bit-equal={same}; plan {plan} "
              f"{'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            fail(f"hopper_experts {label} under autograd: rel {rels}, "
                 f"{launched} launches, repeat bit-equal {same}")
        backward_ms = time_ms(lambda: torch.autograd.grad(
            out, (xh, wh), g, retain_graph=True), 3)
        del dx, dw, rdx, rdw, ref, again, xp, wp
        row = {"label": label, "E": E, "M": M, "K": K, "N": N,
               "type": "bf16", "out": "bfloat16", "max_abs_err": errs["out"],
               "grad_rel": {"dx": rels["dx"], "dw": rels["dw"]},
               "plan": plan,
               "backward_ms": backward_ms,
               "backward_timer": "cuda events, host gaps in"}
        if label == "train_moe_gate_up":
            ms, copies, timer = cold_ms(
                lambda a, b: fm.fp8_matmul_batched(a, b, bf16), (x, w), 20)
            lib, _, lib_timer = cold_ms(torch.bmm, (x, w), 20)
            bms, by = bound_ms(E * (M * K + K * N) * 2 + E * M * N * 2,
                               2.0 * E * M * N * K, "bf16")
            row.update(ms=ms, operand_copies=copies, timer=timer,
                       plain_ms=time_ms(lambda: fm.fp8_matmul_batched_plain(
                           x, w, bf16), 3),
                       library_ms=lib, library_note="torch.bmm",
                       library_timer=lib_timer, bound_ms=bms, bound_by=by)
        print(f"[train-blocks-gemm] {json.dumps(row)}", flush=True)
        rows.append(row)
        del x, w, g, xh, wh, out
    torch.cuda.empty_cache()
    return rows


def perm_backend(seed: int) -> str:
    """Register (once) and name a matmul backend ``torch_perm<seed>``: the
    torch backend's dense GEMM (f32 product of upcast operands, then the
    output type) over a seeded permutation of K, the same for every call
    of one K. Another summation order and nothing else: its bf16 outputs
    part from the torch backend's only where the f32 sums straddle a
    rounding boundary, as a second correct GEMM's do. Its gradient is the
    torch backend's."""
    import torch
    from repro_torch.kernels import registry
    name = f"torch_perm{seed}"
    if name in registry.available_backends():
        return name
    perms = {}

    def dense(x, w, *, out_dtype=torch.bfloat16, bm=None, bn=None,
              bk=None):
        K = w.shape[-2]
        if K not in perms:
            gen = torch.Generator(device=w.device).manual_seed(seed * 7919
                                                               + K)
            perms[K] = torch.randperm(K, generator=gen, device=w.device)
        p = perms[K]
        return torch.matmul(x.float().index_select(-1, p),
                            w.float().index_select(-2, p)).to(out_dtype)
    t = registry.get_backend("torch")
    registry.register_backend(registry.MatmulBackend(
        name=name, dense=dense, fp8=t.fp8, fp8_qdot=t.fp8_qdot,
        sparse24=t.sparse24, description="torch over a permuted K"))
    return name


# K-permuted torch backends (perm_backend) beside the f32 run in a
# recurrent stack's fallback gate (against_reorderings)
TRAIN_PERM_SEEDS = 3


def against_reorderings(tag, cfg, rt, init, batch, hop, ref, held) -> dict:
    """The fallback of a recurrent stack whose step-0 loss or held grad
    norms miss ``check_pair``'s gate, where the recurrence amplifies the
    backends' bf16 rounding: an f32 run of the same weights (f32 weights
    and activations, the torch backend) and TRAIN_PERM_SEEDS K-permuted
    torch backends (``perm_backend``: the torch backend's GEMM summing in
    another order, nothing else). The hopper arm's step-0 loss, and
    separately its held grad norms (the worst leaf's gap, ``norm_gaps``),
    must lie at most F32_FACTOR times as far from the f32 run as the
    farthest of the torch backend and its reorderings; otherwise the run
    fails. ``prefill_against_f32``'s rule has the torch backend alone on
    that side; here its reorderings fail that rule themselves (the torch
    backend makes the f32 run's own library calls on the same shapes and
    lies closer to it than any of them: ROADMAP §3). Printed beside: how
    far each reordering moves the torch arm's own loss and grad norms."""
    import dataclasses
    import torch
    from repro_torch.core import execution as ex
    p32 = tree_f32(init)
    rt32 = dataclasses.replace(rt, act_dtype=torch.float32,
                               param_dtype=torch.float32)
    loss32, norms32, grads = leaf_grad_norms(
        cfg, rt32, ex.parse_policy("bf16:dense:torch"), p32, batch)
    del grads, p32
    runs = {"hopper": (hop["loss0"], hop["grad_norms"]),
            "torch": (ref["loss0"], ref["grad_norms"])}
    for seed in range(1, TRAIN_PERM_SEEDS + 1):
        name = perm_backend(seed)
        loss, norms, grads = leaf_grad_norms(
            cfg, rt, ex.parse_policy(f"bf16:dense:{name}"), init, batch)
        del grads
        runs[name] = (loss, norms)
    torch.cuda.empty_cache()
    dist = {k: {"loss_vs_f32": abs(loss - loss32),
                "grad_vs_f32": max(norm_gaps(norms, norms32, held)),
                "loss_vs_torch": abs(loss - ref["loss0"]),
                "grad_vs_torch": max(norm_gaps(norms, ref["grad_norms"],
                                               held))}
            for k, (loss, norms) in runs.items()}
    out = {"loss_f32": loss32, "distances": dist}
    for k in ("loss", "grad"):
        reach = max(d[f"{k}_vs_f32"] for n, d in dist.items()
                    if n != "hopper")
        out[f"{k}_reach"] = reach
        out[f"{k}_ok"] = dist["hopper"][f"{k}_vs_f32"] <= F32_FACTOR * reach
    ok = out["loss_ok"] and out["grad_ok"]
    perms = [n for n in runs if n.startswith("torch_perm")]
    print(f"[train-blocks] {tag} step 0 against an f32 run, beside the "
          f"torch backend and {len(perms)} K-reorderings of it: loss hopper "
          f"{dist['hopper']['loss_vs_f32']:.3e}, farthest of theirs "
          f"{out['loss_reach']:.3e}; worst grad-norm gap hopper "
          f"{dist['hopper']['grad_vs_f32']:.3e}, farthest of theirs "
          f"{out['grad_reach']:.3e} (hopper at most {F32_FACTOR}x) "
          f"{'ok' if ok else 'MISMATCH'}; a reordering moves the torch "
          f"arm's own loss by "
          + ", ".join(f"{dist[n]['loss_vs_torch']:.2e}" for n in perms)
          + " and its grad norms by "
          + ", ".join(f"{dist[n]['grad_vs_torch']:.3e}" for n in perms)
          + f" (hopper: {dist['hopper']['loss_vs_torch']:.2e}, "
          f"{dist['hopper']['grad_vs_torch']:.3e})", flush=True)
    if not ok:
        fail(f"{tag}: the hopper arm's step-0 loss or grad norms lie farther "
             f"from an f32 run than {F32_FACTOR}x the torch backend and its "
             f"K-reorderings: {out}")
    return out


def train_sublayers(kind, p, cfg, rt):
    """A layer's training forward as its sublayers, each x -> (the
    sublayer's output, which the residual adds to x; its aux loss):
    attention then the MLP or MoE layer; the mamba2 mixer; rwkv6's time
    mix then channel mix (``train_block`` cut where ``layerwise_check``
    cuts it)."""
    import torch
    from repro_torch.models import mamba2 as m2
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import rwkv6 as rk
    from repro_torch.models.attention import attention_block
    from repro_torch.models.layers import rms_norm, swiglu_mlp

    def unit(norm, fn):
        def run(x):
            out = fn(rms_norm(x, p[norm], cfg.norm_eps))
            return out if isinstance(out, tuple) else (out, torch.zeros(
                (), dtype=torch.float32, device=x.device))
        return run
    if kind == "mamba2":
        return [("mamba2", unit("norm1", lambda h: m2.mamba2_block(
            h, p["mamba"], cfg, rt)))]
    if kind == "rwkv6":
        return [("rwkv6 time mix", unit("norm1", lambda h: rk.rwkv6_block(
            h, p["rwkv"], cfg, rt))),
                ("rwkv6 channel mix", unit("norm2", lambda h:
                                           rk.rwkv6_channel_mix(
                                               h, p["rwkv"], cfg, rt)))]
    window = cfg.window_size if kind == "attn_local" else 0
    ffn = (lambda h: moe_mod.moe_mlp(h, p["moe"], cfg, rt)) \
        if kind == "attn_moe" else \
        (lambda h: swiglu_mlp(h, p["mlp"], cfg, rt))
    return [("attention", unit("norm1", lambda h: attention_block(
        h, p["attn"], cfg, rt, window=window))),
            ("moe" if kind == "attn_moe" else "mlp", unit("norm2", ffn))]


def sublayer_grads_check(tag, cfg, params, batch) -> dict:
    """Every sublayer's training forward and backward (``train_sublayers``,
    no remat) under ``bf16:dense:hopper`` and ``bf16:dense:torch``, teacher
    forced as ``layerwise_check`` is for serving: one forward of ``batch``
    under the torch backend gives each sublayer's input, where both
    backends run it. Each sublayer is differentiated along two output
    cotangents, its aux loss entering at AUX_LOSS_WEIGHT: a seeded random
    one, and the torch backend's own step-0 flow (the step-0 loss, CE and
    the aux losses, differentiated sublayer by sublayer from the head
    down). The output, the input's gradient and each of the layer's
    leaves' gradients (a MoE sublayer's router and experts on one routing:
    both sides route the same input) must agree within LAYER_TOL
    (max|diff| / max|torch|). TOP1_ROUTER: a top-1 gate is divided by itself
    (the reference normalises the top-k gates to sum to 1), so the router's
    gradient through the combine weights is 0 in exact arithmetic; what a
    backend computes there is the rounding residue of g/s - g·s/s², as large
    as the experts' outputs times the cotangent allow (in float64, 3e-9 of the
    float32 one), and two backends' expert outputs leave different residues.
    Along the random cotangent, where at llama4-scout's width that residue
    outweighs the aux loss's gradient (the two backends' router gradients part
    by 1.56 of their size on the H100), a top-1 router is held by its aux
    loss's gradient alone (the combine path's gap printed, not held); along
    the step-0 flow, whole. Along the step-0 flow a few entries can sit where
    the flow is ill-conditioned (rwkv6's first token: its wkv output is 0 at
    init, so the per-head norm's backward scales it by rsqrt(64e-5)); a
    sublayer that misses LAYER_TOL there is held instead to TRAIN_PERM_SEEDS
    K-reorderings of the torch backend (``perm_backend``) on the same input
    and cotangent: at least one of them must miss LAYER_TOL too, and the
    hopper gap must be at most F32_FACTOR times the farthest of theirs. End to
    end, a stack that amplifies the backends' bf16 rounding (MoE routing, the
    recurrences) cannot hold its forward or its gradients to such a gate;
    sublayer by sublayer it can."""
    import torch
    from repro_torch.core import execution as ex
    from repro_torch.core import tree
    from repro_torch.models.layers import RuntimeCfg, embed_tokens, rms_norm
    from repro_torch.models.transformer import block_params, layer_kinds
    from repro_torch.runtime import train_loop as tl

    def side(be):
        return ex.apply_policy(cfg, RuntimeCfg(), ex.parse_policy(
            f"bf16:dense:{be}"))
    sides = {be: side(be) for be in ("hopper", "torch")}
    units, inputs, window = [], [], None
    with torch.no_grad():
        # (B, S, d) frames are the stack's input as they are, as
        # forward_hidden takes them; tokens go through the table
        x = (batch["inputs"] if batch["inputs"].dim() == 3 else
             embed_tokens(batch["inputs"], params["embed"])).to(
                 torch.bfloat16)
        for li, (kind, p) in enumerate(zip(layer_kinds(cfg),
                                           params["layers"])):
            p = block_params(kind, p, params)
            if kind == "attn_local" and window is None:
                window = window_control(tag, cfg, p, x, sides["hopper"])
            for si, (_, unit) in enumerate(train_sublayers(
                    kind, p, *sides["torch"])):
                units.append((li, si, kind, p))
                inputs.append(x)
                x = x + unit(x)[0]
    c, r = sides["torch"]
    top = x.detach().requires_grad_(True)
    with torch.enable_grad():
        ce = tl.chunked_cross_entropy(
            rms_norm(top, params["final_norm"], cfg.norm_eps),
            params["head"], batch["labels"], cfg.vocab_size,
            policy=ex.policy_from(c, r))
        flow, = torch.autograd.grad(ce, top)
    del top, x

    def run(i, c, r, cots):
        """Sublayer i under (c, r): its output, and for each cotangent the
        gradients of the input and of each leaf used."""
        li, si, kind, p = units[i]
        xi = inputs[i].detach().requires_grad_(True)
        leaves = [t.detach().requires_grad_(True) for t in tree.leaves(p)]
        it = iter(leaves)
        name, unit = train_sublayers(kind, tree.map_tree(
            lambda _: next(it), p), c, r)[si]
        grads = {}
        with torch.enable_grad():
            out, aux = unit(xi)
            for k, ct in cots.items():
                gs = list(torch.autograd.grad(
                    (out.float() * ct.float()).sum()
                    + tl.AUX_LOSS_WEIGHT * aux, [xi] + leaves,
                    allow_unused=True, retain_graph=True))
                if k == "random" and name == "moe" and \
                        cfg.experts_top_k == 1:
                    # TOP1_ROUTER: along the random cotangent a top-1
                    # router is held by its aux loss's gradient; its
                    # gradient through the combine weights is kept aside
                    ri = 1 + next(j for j, t in enumerate(tree.leaves(p))
                                  if t is p["moe"]["router"])
                    grads["combine residue"] = [gs[ri]]
                    gs[ri], = torch.autograd.grad(
                        tl.AUX_LOSS_WEIGHT * aux, leaves[ri - 1],
                        retain_graph=True)
                grads[k] = [g for g in gs if g is not None]
        return name, out.detach(), grads

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp_min(1e-30))

    def gaps(a, b, k):
        """(output gap, worst gradient gap) of run a against run b."""
        return rel(a[1], b[1]), max(rel(x, y) for x, y in zip(a[2][k],
                                                               b[2][k]))
    tol = LAYER_TOL["bf16"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    worst = {(k, w): (0.0, None) for k in ("random", "flow")
             for w in ("output", "gradients")}
    reordered, residue = [], None
    for i in reversed(range(len(units))):
        cots = {"random": torch.randn(flow.shape, generator=gen,
                                      device="cuda").to(flow.dtype),
                "flow": flow}
        res = {be: run(i, *sides[be], cots) for be in sides}
        at = (units[i][0], res["torch"][0])
        if "combine residue" in res["torch"][2]:
            residue = max(residue or 0.0, rel(
                res["hopper"][2]["combine residue"][0],
                res["torch"][2]["combine residue"][0]))
        for k in cots:
            g = gaps(res["hopper"], res["torch"], k)
            if k == "flow" and max(g) > tol:
                theirs = []
                for seed in range(1, TRAIN_PERM_SEEDS + 1):
                    theirs.append(max(gaps(run(i, *side(perm_backend(
                        seed)), {k: flow}), res["torch"], k)))
                reach = max(theirs)
                reordered.append({"at": at, "hopper": max(g),
                                  "reorderings": theirs,
                                  "ok": reach > tol
                                  and max(g) <= F32_FACTOR * reach})
                continue
            for w, v in zip(("output", "gradients"), g):
                if v >= worst[(k, w)][0]:
                    worst[(k, w)] = (v, at)
        flow = flow + res["torch"][2]["flow"][0]
        inputs[i] = None
        del res
    torch.cuda.empty_cache()
    ok = max(w for w, _ in worst.values()) <= tol \
        and all(f["ok"] for f in reordered)
    for k, what in (("random", "one seeded random cotangent each"),
                    ("flow", "the torch backend's step-0 cotangents")):
        print(f"[{tag}] sublayer by sublayer, forward and backward against "
              f"the torch backend (teacher forced on its step-0 inputs, "
              f"{what}, {len(units)} sublayers): worst max|err|/max|torch| "
              + ", ".join(f"{w} {worst[(k, w)][0]:.3e} at (layer, "
                          f"sublayer) {worst[(k, w)][1]}"
                          for w in ("output", "gradients"))
              + f" (tolerance {tol})"
              + ("".join(f"; {f['at']} held to {len(f['reorderings'])} "
                         f"K-reorderings of the torch backend: hopper "
                         f"{f['hopper']:.3e}, theirs "
                         + ", ".join(f"{v:.3e}" for v in f["reorderings"])
                         + f" (one beyond {tol}, hopper at most "
                           f"{F32_FACTOR}x the farthest: "
                         + ("met" if f["ok"] else "MISSED") + ")"
                         for f in reordered) if k == "flow" else "")
              + (f"; a top-1 router held along the random cotangent by "
                 f"its aux loss's gradient (its gradient through the "
                 f"combine weights, 0 in exact arithmetic, is each "
                 f"backend's rounding residue: they part by {residue:.3e}, "
                 f"not held)" if k == "random" and residue is not None
                 else "")
              + f" {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{tag}: a sublayer's forward or backward differs from the "
             f"torch backend beyond {tol}: {worst}, {reordered}")
    out = {"sublayer_grad_worst_rel": {f"{k} {w}": v for (k, w), (v, _)
                                       in worst.items()},
           "sublayers_held_to_reorderings": reordered}
    if residue is not None:
        out["top1_router_combine_residue_rel"] = residue
    if window is not None:
        out["window_control"] = window
    return out


def window_control(tag, cfg, p, x, side) -> dict:
    """A local layer's attention sublayer (``p``) on its input ``x`` (B, S,
    d) under ``side`` (cfg, rt), with its window and with none
    (``window=0``). Over the positions where the window masks keys (t >=
    window) the two outputs must differ by more than LAYER_TOL (max|diff|
    / max|windowed| there): else the window did not bite, and the
    sublayer check would hold the local layers to nothing a global layer
    lacks. The first positions, which see every key either way, are left
    out of both maxima."""
    from repro_torch.models.attention import attention_block
    from repro_torch.models.layers import rms_norm
    c, r = side
    W, S = cfg.window_size, x.shape[1]
    if S <= W:
        fail(f"{tag}: S={S} is within the window {W}: it cannot mask")
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    out = {w: attention_block(h, p["attn"], c, r, window=w)[:, W:].float()
           for w in (W, 0)}
    rel = float((out[W] - out[0]).abs().max()
                / out[W].abs().max().clamp_min(1e-30))
    tol = LAYER_TOL["bf16"]
    print(f"[{tag}] window control: the first local layer's attention with "
          f"window {W} against window 0 on the same input, over positions "
          f"{W}..{S - 1}: max|diff|/max|windowed| {rel:.3e} (must exceed "
          f"{tol}) {'ok' if rel > tol else 'MISMATCH'}", flush=True)
    if not rel > tol:
        fail(f"{tag}: the window did not bite (rel {rel:.3e} <= {tol})")
    return {"window": W, "positions": [W, S - 1], "rel": rel}


def train_blocks_phase():
    """The TRAIN_BLOCKS stacks at full width, each at its own B and S,
    bf16 weights drawn from a seeded generator on the card: three steps
    under ``bf16:dense:hopper`` and ``bf16:dense:torch``, each arm drawing
    its own init from the seed (one init's bits, held by its checksum; so
    no init outlives the checks, and no two arms are live at once), their
    launches, losses (the MoE stacks' aux too) and step-0 grad norms held
    (not a MoE layer's router and experts; a recurrent stack's loss or
    grad norms that miss, against an f32 run beside the torch backend's
    K-reorderings, ``against_reorderings``), every sublayer's forward and
    backward held teacher forced on the torch backend's step-0 inputs and
    cotangents (gemma3's window shown to bite, ``window_control``), an
    embeddings-input stack's token table given an exactly zero gradient,
    kernel A's expert-batched launch under autograd at the training
    shapes and kernel A at the dense stacks' new ones, one hopper step
    profiled, its peak memory beside the reckoning."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import tree
    from repro_torch.models import init_params
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.models.transformer import reference_leaves
    from repro_torch.optim import adamw
    t_phase = time.perf_counter()
    rt = RuntimeCfg()
    results, summary, expert_rows, gemm_rows = {}, {}, [], []
    hop_tag, ref_tag = TRAIN_BLOCK_ARMS
    for arch, layers, B, S in TRAIN_BLOCKS:
        t0 = time.perf_counter()
        full = get_arch(arch)
        cfg = full if layers is None else dataclasses.replace(
            full, num_layers=layers)
        moments = torch.bfloat16 if arch in TRAIN_BLOCK_BF16_MOMENTS \
            else torch.float32
        opt_cfg = adamw.AdamWConfig(total_steps=1000, warmup_steps=20,
                                    moments_dtype=moments)

        def draw(cfg=cfg):
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            return init_params(cfg, gen, device="cuda")
        init = draw()
        n_params = sum(t.numel() for t in tree.leaves(init))
        reckoned = train_peak_reckoned(cfg, opt_cfg)
        cut = "uncut" if layers is None else \
            f"depth cut from {full.num_layers}"
        print(f"[train-blocks] {arch}: {cfg.num_layers} layers ({cut}; "
              f"{cfg.superlayer_pattern} x {cfg.num_superlayers} + "
              f"{cfg.hybrid_tail_layers} tail), d_model {cfg.d_model}, d_ff "
              f"{cfg.d_ff}, experts {cfg.num_experts} top "
              f"{cfg.experts_top_k}"
              f"{' + shared' if cfg.moe_shared_expert else ''}, window "
              f"{cfg.window_size}, ssm {cfg.ssm_kind or 'none'} "
              f"chunk {min(rt.ssm_chunk, cfg.ssm_chunk)}, input "
              f"{cfg.input_mode}; {n_params / 1e9:.2f} B params; B={B} "
              f"S={S}, remat {cfg.remat}, AdamW moments "
              f"{str(moments).split('.')[-1]}; peak reckoned "
              f"{reckoned['total'] / 1e9:.2f} GB (state "
              f"{reckoned['state'] / 1e9:.2f}, grads "
              f"{reckoned['grads'] / 1e9:.2f}, AdamW's f32 temporaries "
              f"{reckoned['adamw_f32_temporaries'] / 1e9:.2f})", flush=True)
        batches = train_batches(cfg, B, S)
        # held by their grad norms: every leaf but a MoE layer's router
        # and expert stacks, which routing flips make discontinuous
        names = [r.name for r in tree.leaves(reference_leaves(init, cfg))]
        held = [not ("/moe/" in n and "/moe/shared/" not in n)
                for n in names]
        gates = {}
        if cfg.num_experts:
            rows = train_expert_rows(cfg, B * S)
            expert_rows += rows
        gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
        for label, K, N in TRAIN_BLOCK_GEMM_SHAPES.get(arch, ()):
            gemm_rows.append(train_gemm_row(label, B * S, K, N, "bf16",
                                            "bfloat16", gen,
                                            "train-blocks-gemm"))
        gates.update(sublayer_grads_check(f"train-blocks {arch}", cfg,
                                          init, batches[0]))
        checksum = init_checksum(init)
        del init
        torch.cuda.empty_cache()
        spent = {"set-up and checks": time.perf_counter() - t0}
        arms = {}
        for tag in TRAIN_BLOCK_ARMS:
            t1 = time.perf_counter()
            arms[tag] = train_arm(tag, cfg, draw, checksum, batches,
                                  TRAIN_STEPS, opt_cfg, rt,
                                  profile=tag == hop_tag,
                                  label="train-blocks")
            spent[tag] = time.perf_counter() - t1
        t1 = time.perf_counter()
        first = check_pair(f"{arch} {hop_tag}", arms[hop_tag],
                           arms[ref_tag], "bf16", held=held,
                           aux=bool(cfg.num_experts),
                           hard=not cfg.ssm_kind, label="train-blocks")
        gates["step0"] = first
        if not (first["loss_ok"] and first["grad_ok"]):
            gates["against_reorderings"] = against_reorderings(
                f"{arch} {hop_tag}", cfg, rt, draw(), batches[0],
                arms[hop_tag], arms[ref_tag], held)
        if cfg.input_mode == "embeddings":
            nonzero = {tag: a["embed_grad_nonzero"] for tag, a in arms.items()}
            print(f"[train-blocks] {arch}: the token table's step-0 gradient "
                  f"(the stack reads (B, S, d) frames): nonzero entries "
                  f"{nonzero} (must be 0, as jax.grad gives it) "
                  f"{'ok' if not any(nonzero.values()) else 'MISMATCH'}",
                  flush=True)
            if any(nonzero.values()):
                fail(f"{arch}: the unread token table has a nonzero "
                     f"gradient {nonzero}")
            gates["embed_grad_nonzero"] = nonzero
        spent["gates"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        print(f"[train-blocks] {arch}: peak memory "
              + ", ".join(f"{tag} {a['peak_bytes'] / 1e9:.2f} GB"
                          for tag, a in arms.items())
              + f" against {reckoned['total'] / 1e9:.2f} GB reckoned",
              flush=True)
        for tag, a in arms.items():
            results[f"train-blocks {arch} {tag}"] = {
                "launches": a["launches"],
                "expert_batched_launches": a["expert_batched_launches"]}
        summary[arch] = {
            "layers": cfg.num_layers, "params": n_params, "B": B, "S": S,
            "moments": str(moments).split(".")[-1],
            "peak_reckoned_bytes": reckoned, "gates": gates,
            "arms": {tag: {k: a[k] for k in (
                "ms_per_step", "tok_s", "peak_bytes", "state_bytes",
                "launches", "expert_batched_launches")}
                for tag, a in arms.items()},
            "seconds": time.perf_counter() - t0, "seconds_by_part": spent}
        summary[arch]["arms"][hop_tag]["profile"] = arms[hop_tag]["profile"]
        if cfg.num_experts:
            # one backward per expert GEMM per step: gate and up, then
            # down, in each MoE layer
            per = {r["label"]: r["backward_ms"] for r in rows}
            summary[arch]["expert_backward_ms"] = {
                **per, "per_step": cfg.num_layers * (
                    2 * per["train_moe_gate_up"] + per["train_moe_down"])}
        print(f"[train-blocks] {arch}: {summary[arch]['seconds']:.1f}s ("
              + ", ".join(f"{k} {v:.1f}s" for k, v in spent.items()) + ")",
              flush=True)
    print(f"[train-blocks-summary] {json.dumps(summary)}", flush=True)
    print(f"[train-blocks] phase {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return results, expert_rows + gemm_rows, summary


def rounding_row(x, w, extra=None) -> dict:
    """``x @ w`` (bf16, 2-D) held to its exact product (float64): the
    share of bf16 outputs that are not the exact product rounded to
    nearest under kernel A, the torch backend and ``extra`` (a (name,
    dense backend function) pair), and their mean signed error toward
    zero over the RMS of the exact product (negative: the outputs
    shrink); and of the f32 products (kernel A's f32 output, the torch
    backend's f32 product), the RMS error over that RMS and the mean
    signed error toward zero."""
    import torch
    from repro_torch.kernels import fp8_matmul as fm
    from repro_torch.kernels import registry
    torch_dense = registry.get_backend("torch").dense
    exact = x.double() @ w.double()
    near = exact.to(torch.bfloat16)
    scale = exact.pow(2).mean().sqrt()
    bf16 = [("kernel_a", fm.fp8_matmul(x, w, torch.bfloat16)),
            ("torch", torch_dense(x, w, out_dtype=torch.bfloat16))]
    if extra is not None:
        bf16.append((extra[0], extra[1](x, w, out_dtype=torch.bfloat16)))
    row = {"flips": {k: float((v != near).float().mean()) for k, v in bf16},
           "bf16_bias_to_zero": {k: float(((v.double() - exact)
                                           * exact.sign()).mean() / scale)
                                 for k, v in bf16}}
    for k, v in (("kernel_a", fm.fp8_matmul(x, w, torch.float32)),
                 ("torch", x.float() @ w.float())):
        err = v.double() - exact
        row[f"{k}_f32_rel_rms"] = float(err.pow(2).mean().sqrt() / scale)
        row[f"{k}_f32_bias_to_zero"] = float(
            (err * exact.sign()).mean() / scale)
    return row


def gemm_rounding_stats(cfg, params, tokens) -> dict:
    """Every linear of one no-grad forward of ``cfg`` (the torch backend's
    inputs), held to its exact product (``rounding_row``, with
    ``torch_perm1`` beside kernel A and the torch backend)."""
    import torch
    from repro_torch.core import execution as ex
    from repro_torch.kernels import registry
    from repro_torch.models.layers import RuntimeCfg
    perm = registry.get_backend(perm_backend(1)).dense
    torch_dense = registry.get_backend("torch").dense
    rows = []

    def record(x, w, *, out_dtype=torch.bfloat16, bm=None, bn=None,
               bk=None):
        out = torch_dense(x, w, out_dtype=out_dtype)
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        row = {"K": w.shape[0], "N": w.shape[1], "out": str(out_dtype),
               **rounding_row(x2, w.contiguous(), ("torch_perm1", perm))}
        rows.append(row)
        return out
    t = registry.get_backend("torch")
    registry.register_backend(registry.MatmulBackend(
        name="torch_record", dense=record, fp8=t.fp8, fp8_qdot=t.fp8_qdot,
        sparse24=t.sparse24))
    c, r = ex.apply_policy(cfg, RuntimeCfg(),
                           ex.parse_policy("bf16:dense:torch_record"))
    from repro_torch.models import forward
    with torch.no_grad():
        forward(params, tokens, c, r)
    keys = rows[0]["flips"]
    return {"linears": len(rows),
            "flip_share_mean": {k: sum(r_["flips"][k] for r_ in rows)
                                / len(rows) for k in keys},
            "flip_share_max": {k: max(r_["flips"][k] for r_ in rows)
                               for k in keys},
            **{f"{k}_{m}_max": max(abs(r_[f"{k}_{m}"]) for r_ in rows)
               for k in ("kernel_a", "torch")
               for m in ("f32_rel_rms", "f32_bias_to_zero")},
            **{f"{k}_f32_bias_to_zero_mean": sum(
                r_[f"{k}_f32_bias_to_zero"] for r_ in rows) / len(rows)
               for k in ("kernel_a", "torch")}}


def diagnose_train(arch: str = "rwkv6-3b", seeds: int = 4) -> dict:
    """``--diagnose-recurrent``'s training half: where ``arch``'s step-0
    gradients part between the backends at ``[train-blocks]``' depth
    (ROADMAP §3). Gates nothing; prints JSON.

    * ``gemm``: every linear's rounding against its exact product
      (:func:`gemm_rounding_stats`).
    * ``ensemble``: the step-0 loss and held grad norms (``train_arm``'s
      ``leaf_grad_norms``, remat as trained) under the hopper and torch
      backends, ``seeds`` K-permuted torch backends (:func:`perm_backend`)
      and an f32 run: each one's worst held-leaf gap from the torch arm
      and from the f32 run, its loss's distance from both, and layer 0's
      ``w_r`` grad norm."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import execution as ex
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.models.transformer import reference_leaves
    layers = next(t[1] for t in TRAIN_BLOCKS if t[0] == arch)
    full = get_arch(arch)
    cfg = dataclasses.replace(full, num_layers=layers or full.num_layers)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    init = init_params(cfg, gen, device="cuda")
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in SyntheticLM(
        cfg.vocab_size, TRAIN_S, TRAIN_B, seed=SEED).batch_at(0).items()}
    names = [r.name for r in tree.leaves(reference_leaves(init, cfg))]
    held = [not ("/moe/" in n and "/moe/shared/" not in n) for n in names]
    out = {"arch": arch, "layers": cfg.num_layers,
           "gemm": gemm_rounding_stats(cfg, init, batch["inputs"])}
    print(f"[diagnose-train] gemm {json.dumps(out['gemm'])}", flush=True)
    rt = RuntimeCfg()
    w_r = names.index("layers/b0/rwkv/w_r") if "layers/b0/rwkv/w_r" in \
        names else None
    arms = {}
    for tag in ["bf16:dense:torch", "bf16:dense:hopper"] + [
            f"bf16:dense:{perm_backend(s)}" for s in range(1, seeds + 1)]:
        loss, norms, g = leaf_grad_norms(cfg, rt, ex.parse_policy(tag),
                                         init, batch)
        del g
        arms[tag.split(":")[2]] = (loss, norms)
    rt32 = dataclasses.replace(rt, act_dtype=torch.float32,
                               param_dtype=torch.float32)
    p32 = tree_f32(init)
    loss, norms, g = leaf_grad_norms(cfg, rt32, ex.parse_policy(
        "bf16:dense:torch"), p32, batch)
    del g, p32
    arms["f32"] = (loss, norms)
    torch.cuda.empty_cache()
    ens = {}
    for k, (loss, norms) in arms.items():
        ens[k] = {"loss0": loss,
                  "loss_vs_torch": abs(loss - arms["torch"][0]),
                  "loss_vs_f32": abs(loss - arms["f32"][0]),
                  "grad_gap_vs_torch": max(norm_gaps(
                      norms, arms["torch"][1], held)),
                  "grad_gap_vs_f32": max(norm_gaps(
                      norms, arms["f32"][1], held))}
        if w_r is not None:
            ens[k]["layer0_w_r_norm"] = norms[w_r]
    out["ensemble"] = ens
    print(f"[diagnose-train] ensemble {json.dumps(ens)}", flush=True)
    del init
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# [dist]: the distributed dry-run, and the card's own steps under its bound
# ---------------------------------------------------------------------------

# (shape, CLI, perf variants): remat_dots is held below the train_4k
# dry-run's FLOPs (it recomputes no linear)
DIST_CELLS = (("train_4k", "dryrun", None), ("decode_32k", "dryrun", None),
              ("decode_32k", "perf", "baseline,decode_2d_tp"),
              ("train_4k", "perf", "remat_dots"))
# a roofline bound above the measured step by more than this is impossible
DIST_BOUND_SLACK = 1.05


def dist_cli(shape: str, tool: str, variants, out: Path, log: Path):
    """``python -m repro_torch.launch.{dryrun,perf}`` on llama3-8b, as a
    user runs it (CPU work on meta tensors over a fake process group), its
    output to ``log``."""
    args = [sys.executable, "-m", f"repro_torch.launch.{tool}",
            "--arch", "llama3-8b", "--shape", shape, "--out", str(out)]
    if tool == "perf":
        args += ["--variant", variants]
    env = dict(os.environ, PYTHONPATH=str(ARGS.src))
    with open(log, "w") as fh:
        return subprocess.Popen(args, env=env, stdout=fh,
                                stderr=subprocess.STDOUT)


def stop_procs(procs) -> None:
    for *_, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def dist_start() -> list:
    """Start [dist]'s dry-run CLIs, which make no CUDA call: they run
    beside [train-blocks], whose steps keep the device busy, and
    ``dist_phase`` reads them (started in [dist] itself, they held that
    phase for 47-77 s of the script's 1,200 on a slow host). Each is
    stopped when the script exits, a failure's exit too."""
    import atexit
    out_dir = ROOT / "build" / "dist"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for shape, tool, variants in DIST_CELLS:
        path = out_dir / f"{tool}_{shape}.jsonl"
        path.unlink(missing_ok=True)
        log = out_dir / f"{tool}_{shape}.log"
        procs.append((shape, tool, path, log, time.perf_counter(),
                      dist_cli(shape, tool, variants, path, log)))
    atexit.register(stop_procs, procs)
    return procs


def dist_card_roofline(tag, smi, cfg, shape, rt, measured_ms, lower,
                       **kw) -> dict:
    """The dry-run of a step the card ran, on a 1x1 mesh: its roofline
    step bound (the largest of its terms) must not exceed the measured
    time by more than DIST_BOUND_SLACK; prints the roofline share (the
    ideal step, 6·N·D or 2·N·D at peak FLOP/s for train, the minimum bytes
    at HBM rate for decode, over the measured step)."""
    import dataclasses
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import roofline as rl
    from repro_torch.runtime import sharding as sh
    mesh = mesh_mod.make_mesh((1, 1), ("data", "model"))
    rt = dataclasses.replace(rt, shard_fn=sh.make_shard_fn(cfg, mesh, shape))
    traced, _ = lower(cfg, shape, mesh, rt, False, **kw)
    roof = rl.assemble(cfg.name, shape.name, 1, traced.cost, None,
                       cfg.num_superlayers,
                       rl.model_flops_estimate(cfg, shape),
                       min_bytes=rl.min_bytes_estimate(cfg, shape),
                       kind=shape.kind)
    step_ms, ideal_ms = 1e3 * roof.step_s, 1e3 * roof.ideal_s
    out = {"measured_ms": measured_ms, "bound_ms": step_ms,
           "bound_by": roof.bottleneck, "ideal_ms": ideal_ms,
           "bound_share": step_ms / measured_ms,
           "roofline_share": ideal_ms / measured_ms,
           "flops": traced.cost.flops, "bytes": traced.cost.bytes_accessed,
           "kernels": traced.kernels, "memory": traced.memory,
           "trace_s": traced.trace_s, "replicated_ops": traced.replicated_ops,
           "replicated_folds": traced.replicated_folds}
    print(f"[dist] {tag}: measured {measured_ms:.1f} ms/step; traced bound "
          f"{step_ms:.2f} ms ({roof.bottleneck}: {traced.cost.flops:.4g} "
          f"FLOP, {traced.cost.bytes_accessed:.4g} B), share "
          f"{out['bound_share']:.3f}; ideal {ideal_ms:.2f} ms, roofline "
          f"share {out['roofline_share']:.4f}; trace {traced.trace_s:.1f}s "
          f"({smi})", flush=True)
    if step_ms > DIST_BOUND_SLACK * measured_ms:
        fail(f"{tag}: the roofline bound {step_ms:.2f} ms exceeds the "
             f"measured {measured_ms:.2f} ms: an impossible reading")
    if not 0 < ideal_ms <= step_ms:
        fail(f"{tag}: ideal {ideal_ms} ms is not within the bound {step_ms}")
    return out


def dist_dots_step(smi, cfg, rt) -> dict:
    """One [train] step's loss and gradients under ``remat="dots"`` and
    ``"full"`` on the card, deterministic algorithms on: bit-equal, and
    kernel A launched twice per linear (its launch sits inside the
    registry's autograd Function, which the policy recomputes)."""
    import dataclasses
    import torch
    from repro_torch.core import execution as ex
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.runtime import train_loop as tl
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg, gen, device="cuda")
    data = SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=SEED)
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in data.batch_at(0).items()}
    policy = ex.parse_policy("bf16:dense:hopper")
    got = {}
    torch.use_deterministic_algorithms(True)
    try:
        for remat in ("full", "dots"):
            pcfg, prt = ex.apply_policy(
                dataclasses.replace(cfg, remat=remat), rt, policy)
            zero_launch_counts()
            (loss, _), grads = tl.value_and_grad(tl.make_loss_fn(pcfg, prt))(
                params, batch)
            torch.cuda.synchronize()
            got[remat] = (loss, tree.leaves(grads), launch_counts())
            del grads
    finally:
        torch.use_deterministic_algorithms(False)
    (lf, gf, nf), (ld, gd, nd) = got["full"], got["dots"]
    same = bool(torch.equal(lf, ld)) and len(gf) == len(gd) and all(
        torch.equal(a, b) for a, b in zip(gf, gd))
    want = train_launches_expected(cfg, "bf16:dense:hopper", 1)["launches"]
    print(f"[dist] remat=dots step: loss {float(ld):.6f}, loss and "
          f"{len(gd)} gradient leaves bit-equal to remat=full: {same}; "
          f"launches {nd} (full {nf}, expected {want}) ({smi})", flush=True)
    if not same:
        fail("remat=dots: loss or gradients differ from remat=full")
    if nd != want or nf != want:
        fail(f"remat=dots launches {nd}, full {nf}; the code implies {want}")
    del params, gf, gd
    torch.cuda.empty_cache()
    return {"train bf16:dense:hopper remat=dots": {"launches": nd}}


def dist_phase(smi, train_summary, serve_dense, procs) -> dict:
    """The dry-run CLIs on llama3-8b's production cells (``procs``, from
    ``dist_start``); [train]'s step and [serve]'s decode step dry-run on a
    1x1 mesh and held to their measured times; one [train] step under
    ``remat="dots"``."""
    import json as _json
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import execution as ex
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.optim import adamw
    t_phase = time.perf_counter()
    results = {}
    try:
        cfg = train_cfg()
        arm = train_summary["bf16:dense:hopper"]
        policy = ex.parse_policy("bf16:dense:hopper")
        tr = dist_card_roofline(
            "[train] step (llama3-8b, 8 layers, B=4 S=512, "
            "bf16:dense:hopper)", smi, cfg,
            ShapeConfig("train_card", TRAIN_S, TRAIN_B, "train"),
            RuntimeCfg(policy=policy), arm["ms_per_step"], dr.lower_train,
            opt_cfg=adamw.AdamWConfig(total_steps=1000, warmup_steps=20))
        by = tr["memory"]["argument_by_input"]
        state = sum(by[k] for k in ("params", "master", "mu", "nu"))
        print(f"[dist] [train] state from the specs {state} B = "
              f"{state / 2**30:.2f} GiB, allocated on the card "
              f"{arm['state_bytes']} B; predicted peak "
              f"{tr['memory']['per_device_total'] / 1e9:.2f} GB beside the "
              f"measured {arm['peak_bytes'] / 1e9:.2f} GB ({smi})",
              flush=True)
        if state != arm["state_bytes"]:
            fail(f"[dist] state bytes {state} from the specs, "
                 f"{arm['state_bytes']} allocated by [train]")
        serve_cfg = get_arch("llama3-8b")
        de = dist_card_roofline(
            f"[serve] decode step (llama3-8b, 32 layers, {SLOTS} slots, "
            f"max_len {MAX_LEN}, bf16:dense:hopper)", smi, serve_cfg,
            ShapeConfig("serve_card", MAX_LEN, SLOTS, "decode"),
            RuntimeCfg(use_pallas=True, policy=policy),
            serve_dense["decode_ms_per_step"], dr.lower_decode)
        mesh_mod.destroy()
        results.update(dist_dots_step(smi, cfg, RuntimeCfg()))
        flops = {}
        for shape, tool, path, log, t0, proc in procs:
            waited = time.perf_counter()
            proc.wait(timeout=600)
            secs = time.perf_counter() - t0
            text = log.read_text()
            tail = [ln for ln in text.splitlines()
                    if not ln.startswith("[rank")][-6:]
            print(f"[dist] {tool} llama3-8b {shape}: rc {proc.returncode} "
                  f"in {secs:.1f}s ({time.perf_counter() - waited:.1f}s "
                  "of it waited for here); " + " | ".join(tail), flush=True)
            if proc.returncode != 0:
                fail(f"[dist] {tool} {shape} exited {proc.returncode}")
            recs = [_json.loads(ln) for ln in path.read_text().splitlines()]
            if not recs or not all(r["ok"] for r in recs):
                fail(f"[dist] {tool} {shape}: a cell failed")
            if tool == "dryrun" and "OK" not in text:
                fail(f"[dist] dryrun {shape} printed no OK")
            for r in recs:
                flops[(shape, r.get("variant", "baseline"))] = \
                    r["full"]["flops"]
                # a fold gathered for want of a DTensor rule is the
                # trace's artifact, not the plan's cost: no bound
                if r["replicated_folds"]:
                    fail(f"[dist] {tool} {shape} "
                         f"{r.get('variant', 'cell')}: "
                         f"{r['replicated_folds']} folds ran gathered "
                         f"({r['replicated_ops']}): not a bound")
                wire = {k: v["wire_bytes"]
                        for k, v in r["full"]["collectives"].items()}
                print(f"[dist] {tool} {shape} "
                      f"{r.get('variant', 'cell')}: per-device wire bytes "
                      f"by kind {_json.dumps(wire)}; roofline "
                      f"{_json.dumps({k: r['roofline'][k] for k in ('compute_s', 'memory_s', 'collective_s', 'bottleneck', 'roofline_fraction')})}; "
                      f"GiB/dev {r['memory']['per_device_total'] / 2**30:.2f};"
                      f" trace {r['trace_s']:.1f}s; flops "
                      f"{r['full']['flops']:.6g}; replicated "
                      f"{r['replicated_ops']}", flush=True)
        base, dots = (flops[("train_4k", v)]
                      for v in ("baseline", "remat_dots"))
        print(f"[dist] train_4k remat_dots {dots:.6g} FLOP/device, "
              f"{base - dots:.6g} below the baseline's {base:.6g}",
              flush=True)
        if not dots < base:
            fail("[dist] train_4k: remat_dots recomputes as much as the "
                 "baseline")
    finally:
        stop_procs(procs)
        mesh_mod.destroy()
    summary = {"train": {k: v for k, v in tr.items() if k != "memory"},
               "train_memory": tr["memory"],
               "decode": {k: v for k, v in de.items() if k != "memory"},
               "nvidia_smi": smi}
    print(f"[dist-summary] {_json.dumps(summary)}", flush=True)
    print(f"[dist] phase {time.perf_counter() - t_phase:.1f}s ({smi})",
          flush=True)
    return results


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


def check_serve(tag, run, base, launches, cfg, policy=None):
    """``policy`` (default: the tag) names the run's policy spec; ``cfg``
    decides the gates. For a MoE stack the logits and tokens against the
    torch backend are printed and kept but do not fail the run (its
    routing is discontinuous in its input; it is held layer by layer
    instead: ``layerwise_check``). For a recurrent stack the first
    prefill's logits are printed and not gated (they are held layer by
    layer and to an f32 run instead: ``prefill_against_f32``). A stack
    with no attention layer (rwkv6-3b) has kernel B off its path."""
    policy = policy or tag
    tol = LOGIT_TOL[policy.split(":")[0]]
    gate_e2e, gate_prefill = not cfg.num_experts, not cfg.ssm_kind
    check_completed(tag, run)
    on_path = tuple(k for k in PATH_KERNELS[policy.split(":")[1]]
                    if attention_layers(cfg) or k != "flash_attention")
    for name, n in launches.items():
        if (n <= 0) if name in on_path else (n != 0):
            fail(f"{tag}: kernel {name} was launched {n} times on the main "
                 f"path (its kernels: {', '.join(on_path)})")
    # prefill: the same prompt under both backends; decode: the torch
    # backend's step from the hopper run's own state (tokens, caches).
    # ``base`` None: the torch backend served no run (an fp8 MoE stack,
    # ``serve_against_torch``), so only the decode step is compared
    pre = None if base is None else float(
        (run["first"]["prefill"] - base["first"]["prefill"]).abs().max())
    rows = run["first"]["decode_rows"]
    dec = float((run["first"]["decode"][rows]
                 - run["first"]["decode_twin"][rows]).abs().max())
    print(f"[serve] {tag}: logits vs torch backend: first prefill "
          + ("not served on the torch backend" if pre is None else
             f"max_abs_err={pre:.4f}" + ("" if gate_prefill else
                                         " (held to an f32 run instead)"))
          + f", first decode max_abs_err={dec:.4f} (tolerance {tol})",
          flush=True)
    if gate_e2e and not ((pre <= tol or not gate_prefill) and dec <= tol):
        fail(f"{tag}: logits differ from the torch backend beyond {tol}")
    if base is None:
        res = dict(run_times(tag, run), launches=launches,
                   first_prefill_err=None, first_decode_err=dec)
        print(f"[serve-time] {json.dumps(res)}", flush=True)
        return res
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
        if gate_e2e and margin[flip] >= 2 * tol:
            fail(f"{tag}: request {uid} token {flip} differs from the torch "
                 f"backend at top-2 margin {margin[flip]:.3f} >= {2 * tol}")
        first_tie = next((i for i, m in enumerate(margin) if m < 2 * tol),
                         None)
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
                paged_rows, sweep_launches, serve, expert_rows, train_rows,
                train_drow, block_rows):
    def pick(rows, **match):
        return next(r for r in rows
                    if all(r[k] == v for k, v in match.items()))

    def measured(row):
        # the numbers a kernel's entry takes from its timed row, with the
        # timer of ms and of library_ms ("profiler" or "cuda events")
        return {k: row[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "timer", "library_timer")}

    g = pick(gemm_rows, label="decode_mlp", type="bf16")
    f = pick(flash_rows, S=128, hd=128)
    d = pick(sparse24_rows, label="decode_gate_up", values="bf16")
    e = pick(block24_rows, M=4, block=128)
    # the runs of [dense-wide]'s stacks (served, and chameleon-34b's
    # [train-blocks] arms) count in their own entries below, not in these
    wide = tuple(f"{arch} " for arch, *_ in DENSE_WIDE) + (
        "train-blocks chameleon-34b ",)
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
        by_policy = {p: r["launches"][name] for p, r in serve.items()
                     if not p.startswith(wide)}
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "launches": sum(by_policy.values()),
                    "launches_by_policy": by_policy,
                    **measured(row), "shape": shape})
    # kernel A's expert-batched entry ([moe]) and kernel B at gemma3's
    # head_dim 256 ([local]): the same sources, their own rows
    x = pick(expert_rows, label="moe_decode_gate_up", type="bf16")
    h = pick(flash_rows, S=1040, hd=256)
    for name, row, source, replaces, by_policy, shape in (
            ("gemm_experts", x, "src/repro_torch/kernels/csrc/gemm.cu",
             "src/repro/kernels/fp8_matmul.py:56 (vmapped over experts, "
             "src/repro/models/moe.py:149-164)",
             {p: r.get("expert_batched_launches", 0)
              for p, r in serve.items() if p.startswith(MOE_ARCH)},
             f"E={x['E']} M={x['M']} K={x['K']} N={x['N']} bf16->bf16"),
            ("flash_attention_hd256", h,
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:76",
             {p: r["launches"]["flash_attention"] for p, r in serve.items()
              if p.startswith(LOCAL_ARCH)},
             f"B={h['B']} h={h['h']} kvh={h['kvh']} S={h['S']} hd={h['hd']} "
             "causal bf16")):
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "launches": sum(by_policy.values()),
                    "launches_by_policy": by_policy,
                    **measured(row), "shape": shape})
    # the recurrent stacks' new shapes ([ssm], [hybrid]): kernel A at N =
    # 64 and at rwkv6-3b's channel-mix width, kernel D at N = 64, kernel B
    # at head_dim 64 with group 1
    a64 = pick(gemm_rows, label="zamba2_decode_n64", type="bf16")
    arw = pick(gemm_rows, label="rwkv6_decode_ck", type="bf16")
    d64 = pick(sparse24_rows, label="zamba2_decode_n64", values="bf16")
    b64 = pick(flash_rows, S=512, hd=64)
    for name, row, source, replaces, arch, kernel, shape in (
            ("gemm_n64", a64, "src/repro_torch/kernels/csrc/gemm.cu",
             "src/repro/kernels/fp8_matmul.py:56", HYBRID_ARCH, "gemm",
             f"M={a64['M']} K={a64['K']} N={a64['N']} bf16->bf16"),
            ("gemm_rwkv6", arw, "src/repro_torch/kernels/csrc/gemm.cu",
             "src/repro/kernels/fp8_matmul.py:56", SSM_ARCH, "gemm",
             f"M={arw['M']} K={arw['K']} N={arw['N']} bf16->bf16"),
            ("sparse24_gemm_n64", d64,
             "src/repro_torch/kernels/csrc/sparse24_gemm.cu",
             "src/repro/kernels/sparse24_matmul.py:68", HYBRID_ARCH,
             "sparse24_gemm",
             f"M={d64['M']} K={d64['K']} N={d64['N']} packed bf16->bf16"),
            ("flash_attention_hd64", b64,
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:76", HYBRID_ARCH,
             "flash_attention",
             f"B={b64['B']} h={b64['h']} kvh={b64['kvh']} S={b64['S']} "
             f"hd={b64['hd']} causal bf16")):
        by_policy = {p: r["launches"][kernel] for p, r in serve.items()
                     if p.startswith(arch)}
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "launches": sum(by_policy.values()),
                    "launches_by_policy": by_policy,
                    **measured(row), "shape": shape})
    # the training path ([train]): kernel A at the gate/up shape with M =
    # B·S = 2048 and kernel D at the prune+pack arm's gate/up; launches
    # from the train arms' main-path runs
    ta = pick(train_rows, label="train_gate_up", type="bf16")
    for name, row, source, kernel, shape in (
            ("gemm_train", ta, "src/repro_torch/kernels/csrc/gemm.cu",
             "gemm", f"M={ta['M']} K={ta['K']} N={ta['N']} bf16->bf16"),
            ("sparse24_gemm_train", train_drow,
             "src/repro_torch/kernels/csrc/sparse24_gemm.cu",
             "sparse24_gemm",
             f"M={train_drow['M']} K={train_drow['K']} N={train_drow['N']}"
             " packed bf16->bf16 (pruned and packed per call)")):
        by_policy = {p: r["launches"][kernel] for p, r in serve.items()
                     if p.startswith("train ")}
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": "src/repro/kernels/fp8_matmul.py:56"
                    if kernel == "gemm"
                    else "src/repro/kernels/sparse24_matmul.py:68",
                    "launches": sum(by_policy.values()),
                    "launches_by_policy": by_policy,
                    **measured(row), "shape": shape})
    # kernel A's expert-batched launch under autograd ([train-blocks]):
    # granite's expert gate/up at the training step's shape (two groups of
    # capacity 256 rows per expert); launches from the [train-blocks] arms
    xt = pick(block_rows, label="train_moe_gate_up", E=40)
    by_policy = {p: r["expert_batched_launches"] for p, r in serve.items()
                 if p.startswith(f"train-blocks {MOE_ARCH} ")}
    out.append({"name": "gemm_experts_train", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/gemm.cu",
                "replaces": "src/repro/kernels/fp8_matmul.py:56 (vmapped "
                            "over experts, src/repro/models/moe.py:149-164)",
                "launches": sum(by_policy.values()),
                "launches_by_policy": by_policy, **measured(xt),
                "shape": f"E={xt['E']} M={xt['M']} K={xt['K']} N={xt['N']} "
                         "bf16->bf16, forward of an autograd Function"})
    # llama4-scout's top-1 experts ([moe-top1] serving, [train-blocks]
    # training) and kernel B at its 40 query heads over 8 kv heads; kernel
    # A at gemma3-12b's and musicgen-medium's training gate/up; the widest
    # dense stacks ([dense-wide]): kernel A at llama3-405b's decode gate/up
    # (launches: every linear and head of the three arms' runs, the serving
    # CLI's and chameleon-34b's training arms' too) and at its head (the head's own launches, counted by
    # output width), kernel B at GQA group 8 (64 query heads over 8:
    # chameleon-34b, deepseek-67b) and 16 (128 over 8: llama3-405b);
    # launches from those runs
    x1 = pick(expert_rows, label="top1_decode_gate_up", type="bf16")
    x1t = pick(block_rows, label="train_moe_gate_up", E=16)
    b40 = pick(flash_rows, S=128, hd=128, h=40)
    ag = pick(block_rows, label="gemma3_train_gate_up")
    am = pick(block_rows, label="musicgen_train_gate_up")
    aw = pick(gemm_rows, label="d16384_decode_gate_up", type="bf16")
    ah = pick(gemm_rows, label="llama3_405b_decode_head", type="bf16")
    b8 = pick(flash_rows, S=128, hd=128, h=64)
    b16 = pick(flash_rows, S=128, hd=128, h=128)
    gemm_src = "src/repro_torch/kernels/csrc/gemm.cu"
    gemm_tpu = "src/repro/kernels/fp8_matmul.py:56"
    flash_src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    flash_tpu = "src/repro/kernels/flash_attention.py:76"
    experts_src = (f"{gemm_tpu} (vmapped over experts, "
                   "src/repro/models/moe.py:149-164)")

    def flash_shape(b):
        return (f"B={b['B']} h={b['h']} kvh={b['kvh']} S={b['S']} "
                f"hd={b['hd']} causal bf16")
    for name, row, source, replaces, prefix, key, shape in (
            ("gemm_experts_top1", x1, gemm_src, experts_src, TOP1_ARCH,
             "expert_batched_launches",
             f"E={x1['E']} M={x1['M']} K={x1['K']} N={x1['N']} bf16->bf16"),
            ("gemm_experts_train_top1", x1t, gemm_src, experts_src,
             f"train-blocks {TOP1_ARCH} ", "expert_batched_launches",
             f"E={x1t['E']} M={x1t['M']} K={x1t['K']} N={x1t['N']} "
             "bf16->bf16, forward of an autograd Function"),
            ("flash_attention_h40", b40, flash_src, flash_tpu, TOP1_ARCH,
             "flash_attention", flash_shape(b40)),
            ("gemm_train_gemma3", ag, gemm_src, gemm_tpu,
             f"train-blocks {LOCAL_ARCH} ", "gemm",
             f"M={ag['M']} K={ag['K']} N={ag['N']} bf16->bf16"),
            ("gemm_train_musicgen", am, gemm_src, gemm_tpu,
             "train-blocks musicgen-medium ", "gemm",
             f"M={am['M']} K={am['K']} N={am['N']} bf16->bf16"),
            ("gemm_wide", aw, gemm_src, gemm_tpu, wide, "gemm",
             f"M={aw['M']} K={aw['K']} N={aw['N']} bf16->bf16"),
            ("gemm_head_wide", ah, gemm_src, gemm_tpu, "llama3-405b ",
             "head_launches",
             f"M={ah['M']} K={ah['K']} N={ah['N']} bf16->f32"),
            ("flash_attention_g8", b8, flash_src, flash_tpu,
             ("chameleon-34b ", "deepseek-67b "), "flash_attention",
             flash_shape(b8)),
            ("flash_attention_g16", b16, flash_src, flash_tpu,
             "llama3-405b ", "flash_attention", flash_shape(b16))):
        by_policy = {p: (r["launches"][key] if key in r["launches"]
                         else r[key])
                     for p, r in serve.items() if p.startswith(prefix)}
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "launches": sum(by_policy.values()),
                    "launches_by_policy": by_policy,
                    **measured(row), "shape": shape})
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
                **measured(e),
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
                **measured(c),
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
    ap.add_argument("--diagnose-recurrent", action="store_true",
                    help="build, then print the recurrent stacks' rounding "
                         "diagnosis (serving: free-running hidden states, "
                         "one-ulp input nudge; training: rwkv6-3b's GEMM "
                         "rounding, step-0 gradients under K-reordered "
                         "GEMMs, each layer on the torch backend's own "
                         "input and cotangent) and no result line")
    ap.add_argument("--sample-only", action="store_true",
                    help="build, then run [serve] up to its [sample] phase "
                         "(llama3-8b greedy dense, paged and fp8, then "
                         "sampled) and print no result line")
    ap.add_argument("--train-blocks-only", action="store_true",
                    help="build, then run the [train-blocks] phase alone "
                         "and print no result line")
    ap.add_argument("--moe-top1-only", action="store_true",
                    help="build, then run the [moe-top1] phase alone "
                         "(llama4-scout-17b-a16e served at 8 of its 48 "
                         "layers) and print no result line")
    ap.add_argument("--dense-wide-only", action="store_true",
                    help="build, then kernels A and B at [dense-wide]'s "
                         "shapes and the [dense-wide] phase alone "
                         "(chameleon-34b whole and through the serving "
                         "CLI, deepseek-67b and llama3-405b at a depth "
                         "cut) and print no result line")
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
               "gemm": gemm_phase(), "experts": expert_gemm_phase(),
               "flash": flash_phase(),
               "sparse24": sparse24_phase(), "block24": block24_phase(),
               "paged": paged_phase()}
    keep = ("label", "E", "M", "K", "N", "S", "hd", "type", "values",
            "block", "ms", "timer", "event_ms", "library_ms",
            "library_timer", "bound_ms", "plan",
            "host_us_per_call")
    for name in ("gemm", "experts", "flash", "sparse24", "block24", "paged"):
        summary[name] = [{k: r[k] for k in keep if k in r}
                         for r in summary[name]]
    print(f"[kernels-only] {json.dumps(summary)}", flush=True)
    return 0


ARGS = None


def main() -> int:
    global ARGS
    ARGS = parse_args(sys.argv[1:])
    # cuBLAS reproducible under deterministic algorithms (the [train] CLI
    # arm's bitwise resume): set before any cuBLAS handle exists
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    smi = preflight(ARGS.src.resolve())
    if ARGS.kernels_only:
        return kernels_only(smi)
    if ARGS.diagnose_recurrent:
        build_phase()
        diagnose_recurrent()
        diagnose_train()
        return 0
    if ARGS.train_blocks_only:
        build_phase()
        train_blocks_phase()
        return 0
    if ARGS.moe_top1_only:
        build_phase()
        moe_top1_phase()
        return 0
    if ARGS.sample_only:
        build_phase()
        serve_phase()
        return 0
    if ARGS.dense_wide_only:
        build_phase()
        gemm_phase(WIDE_GEMM_SHAPES)
        flash_phase(WIDE_FLASH_SHAPES)
        dense_wide_phase()
        return 0
    build_phase()
    gemm_rows = gemm_phase()
    expert_rows = expert_gemm_phase()
    flash_rows = flash_phase()
    sparse24_rows = sparse24_phase()
    block24_rows = block24_phase()
    paged_rows = paged_phase()
    sweep_records, sweep_launches = sweep_phase()
    profile_launches = profile_phase(smi, sweep_records)
    streams_phase()
    serve = serve_phase()
    serve.update(moe_phase())
    serve.update(moe_top1_phase())
    serve.update(dense_wide_phase())
    serve.update(local_phase())
    serve.update(ssm_phase())
    serve.update(hybrid_phase())
    train, train_rows, train_drow, train_summary = train_phase()
    serve.update(train)
    dist_procs = dist_start()
    blocks, block_rows, _ = train_blocks_phase()
    serve.update(blocks)
    serve.update(dist_phase(smi, train_summary, serve["bf16:dense:hopper"],
                            dist_procs))
    # [profile]'s kernel A launches (occupancy, latency, timer check and
    # A/A block sweep under hopper) join A's entry of the kernels line
    serve["profile"] = {"launches": dict.fromkeys(launch_counts(), 0)}
    serve["profile"]["launches"]["gemm"] = profile_launches
    print(json.dumps(kernel_line(gemm_rows, flash_rows, sparse24_rows,
                                 block24_rows, paged_rows, sweep_launches,
                                 serve, expert_rows, train_rows,
                                 train_drow, block_rows)), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
