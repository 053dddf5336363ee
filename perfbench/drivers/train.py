"""Training through ``runtime/train_loop.make_train_step``.

Set-up builds one train state and one step from the seed's weights and
runs the first ``compared_steps`` steps with it, each on a batch of its
own (``batch(i)``: the seed's tokens, or its float32 frames where the
stack reads embeddings, with the seed's labels): they warm every shape
up, and they are what the check reads: each step's loss, each leaf's
first gradient as AdamW got it (its first moment after one step over
``1 - b1``), and each leaf's change after the last of them (its float32
master against the initial weights, drawn again from the seed). The same
state and step then run for ``--seconds`` on further batches, each step
ending in its loss's host read.

After the window: the peak memory is read, the program's state is freed,
and the float32 reference runs the compared steps from the same weights
on the same batches.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench.harness import weights
from perfbench.harness.trace import Stretch
from perfbench.reference import model as refm

TRIES = 5      # profiled steps a traced run may take before it gives up


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def batch_maker(ctx):
    """``batch(i)``: the i-th step's batch, the same for the same seed."""
    import torch
    b, s, dev, c = ctx.mix["batch"], ctx.mix["seq"], ctx.device, ctx.ref
    embeddings = ctx.conf["input"] == "embeddings"

    def batch(i: int) -> dict:
        gen = torch.Generator(device=dev)
        gen.manual_seed(weights.sub_seed(ctx.seed, 1000 + i))
        labels = torch.randint(0, c.vocab, (b, s), generator=gen,
                               device=dev)
        if embeddings:
            inputs = torch.randn((b, s, c.d), generator=gen, device=dev)
        else:
            inputs = torch.randint(0, c.vocab, (b, s), generator=gen,
                                   device=dev)
        return {"inputs": inputs, "labels": labels}
    return batch


def change_norms(leaves, seed, device, now) -> list:
    """Each leaf's distance from its initial value: ``now[i]`` (float32)
    against the weights drawn again from ``seed``."""
    import torch
    sq = [0.0] * len(leaves)

    def visit(i, lo, init):
        part = now[i].reshape(-1)[lo:lo + init.numel()]
        sq[i] += float(torch.sum((part - init.float()) ** 2))
    weights.leaf_init(leaves, seed, device, visit)
    for i, lf in enumerate(leaves):
        if not lf.scale:                       # drawn as zeros
            sq[i] = float(torch.sum(now[i].float() ** 2))
    return [float(np.sqrt(v)) for v in sq]


def _plant(ctx, step):
    """A fault under the timed path, for the harness's own tests only:
    ``unchanged``: the step returns the state as it was; ``half``: the
    step sees the first half of its batch."""
    if ctx.fault is None:
        return step
    if ctx.fault == "half":
        def half(state, batch):
            n = batch["labels"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})
        return half
    if ctx.fault == "unchanged":
        from repro_torch.core import tree

        def unchanged(state, batch):
            kept = [t.clone() for t in tree.leaves(state)]
            new, metrics = step(state, batch)
            for t, old in zip(tree.leaves(state), kept):
                t.copy_(old)
            return state, metrics
        return unchanged
    raise ValueError(f"no fault {ctx.fault!r} in training")


def run(ctx) -> dict:
    import torch
    from repro_torch.core import execution as ex
    from repro_torch.core import tree
    from repro_torch.kernels import _build
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.models.transformer import params_shape
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop as tl
    ctx.part("imports")
    mix, dev, spans = ctx.mix, ctx.device, ctx.spans
    o = mix["optimizer"]
    if dev.type == "cuda":
        _build.load("gemm")
    ctx.part("kernels")
    shape_tree = params_shape(ctx.cfg)
    params, leaves = weights.make(shape_tree, ctx.seed, dev)
    _sync(dev)
    ctx.part("weights")
    opt = adamw.AdamWConfig(
        learning_rate=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
        weight_decay=o["weight_decay"], warmup_steps=o["warmup_steps"],
        total_steps=o["total_steps"], grad_clip=o["grad_clip"],
        moments_dtype=torch.float32)
    state = tl.init_state(params, opt)
    del params
    step = _plant(ctx, tl.make_train_step(
        ctx.cfg, opt, RuntimeCfg(),
        policy=ex.parse_policy(ctx.conf["policy"])))
    batch = batch_maker(ctx)
    ctx.part("state")

    n_cmp = mix["compared_steps"]
    losses, grad_norms = [], None
    for i in range(1, n_cmp + 1):
        state, m = step(state, batch(i))
        losses.append(float(m["loss"]))
        if i == 1:
            grad_norms = [float(torch.linalg.vector_norm(mu.float()))
                          / (1 - o["b1"]) for mu in tree.leaves(state.opt.mu)]
    moved = change_norms(leaves, ctx.seed, dev,
                         tree.leaves(state.opt.master))
    _sync(dev)
    ctx.part("first steps")

    from perfbench.harness.bench import process_age_s
    setup_s = process_age_s()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tokens = mix["batch"] * mix["seq"]
    record, tries, i = None, 0, n_cmp
    t_start = time.perf_counter()
    t_stop = t_start + ctx.seconds
    while time.perf_counter() < t_stop:
        i += 1
        stretch = None
        if ctx.trace and record is None and tries < TRIES \
                and i > n_cmp + 1:
            stretch, tries = Stretch(spans), tries + 1
            stretch.start()
        with spans.span("step", tokens=tokens):
            state, m = step(state, batch(i))
            float(m["loss"])
        if stretch is not None:
            record = stretch.stop()
            if record is not None:
                record["steps"] = 1
    _sync(dev)
    t_end = time.perf_counter()
    if ctx.trace:
        ctx.log(f"profiled steps: {tries}, the last "
                + ("whole" if record is not None else "lost records"))
    window = t_end - t_start
    steps = i - n_cmp
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    e2e = {"train_tok_s": steps * tokens / window, "setup_s": setup_s}
    rec = {"kind": "train", "ref": ctx.ref, "window_s": window,
           "traced_s": spans.traced_s, "spans": spans.items, "steps": steps, "batch": mix["batch"],
           "seq": mix["seq"], "stretch": record}

    del state, step, m
    from perfbench.harness.bench import free_memory
    free_memory()
    checks, correct = check(ctx, shape_tree, leaves, batch, losses,
                            grad_norms, moved)
    return {"e2e": e2e, "record": rec, "correct": correct,
            "checks": checks, "attempted": steps, "failed": 0,
            "memory_peak_bytes": int(peak), "setup_parts": ctx.setup}


def reference(ctx, shape_tree, leaves, batch):
    """The reference's losses, first (clipped) gradient norms and change
    norms over the compared steps."""
    import torch
    refm.f32_matmuls()
    o = ctx.mix["optimizer"]
    init, _ = weights.make(shape_tree, ctx.seed, ctx.device)
    flat = [t.float() for t in refm.leaves_of(init)]
    del init
    opt = refm.AdamW(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                     weight_decay=o["weight_decay"],
                     warmup=o["warmup_steps"], total=o["total_steps"],
                     clip=o["grad_clip"])
    first = {}

    def watch(n, grads, mu):
        if n == 1:
            first["clipped"] = [float(torch.linalg.vector_norm(g))
                                for g in grads]
    batches = [batch(i) for i in range(1, ctx.mix["compared_steps"] + 1)]
    losses = refm.train_steps(flat, lambda fl: refm.rebuild(shape_tree, fl),
                              batches, ctx.ref, opt,
                              refm.decay_flags(shape_tree), watch)
    moved = change_norms(leaves, ctx.seed, ctx.device, flat)
    del flat
    return losses, first["clipped"], moved


def worst_gap(got, ref, counted) -> float:
    """The widest gap of two norms over the counted leaves, each against
    the reference's norm of that leaf."""
    return max(abs(got[i] - ref[i]) / ref[i] for i in counted)


def check(ctx, shape_tree, leaves, batch, losses, grad_norms, moved):
    """(checks, correct): the worst step's loss, the worst leaf's first
    gradient and the worst leaf's change, each as a gap of norms against
    the reference's norm of that leaf. Leaves whose reference gradient is
    under a thousandth of the median leaf's are nought to rounding (they
    move under AdamW by round-off alone) and are left out of both."""
    r_losses, r_grads, r_moved = reference(ctx, shape_tree, leaves, batch)
    g_med = float(np.median(r_grads))
    counted = [i for i, g in enumerate(r_grads) if g >= 1e-3 * g_med]
    for name, a, b in (("gradient", grad_norms, r_grads),
                       ("change", moved, r_moved)):
        worst = sorted(counted, key=lambda i: -abs(a[i] - b[i]) / b[i])[:3]
        ctx.log(f"widest {name} gaps: " + "; ".join(
            "{} {:.4g}".format("/".join(map(str, leaves[i].path)),
                               abs(a[i] - b[i]) / b[i]) for i in worst))
    got = {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                           r_losses)),
        "grad_norm_gap": worst_gap(grad_norms, r_grads, counted),
        "change_norm_gap": worst_gap(moved, r_moved, counted)}
    # a number the cell's limits leave out is read, not compared
    checks = {k: {"value": v, "limit": ctx.limits.get(k)}
              for k, v in got.items()}
    correct = all(np.isfinite(v) and v <= ctx.limits[k]
                  for k, v in got.items() if k in ctx.limits)
    return checks, bool(correct)
