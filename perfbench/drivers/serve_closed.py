"""Serving in a closed loop through ``ServeSession``'s slot-level API.

``clients`` callers each wait for their answer and send the next request
at once (no think time), in the mix's order. Set-up admits every client's
first request and runs one decode step, so the window opens on full
slots; then, until ``--seconds`` have passed, each turn admits whatever
clients are waiting (``admit``: a bulk prefill that ends in the first
token's host read) and runs one decode step over every slot
(``decode_once``, which ends in the tokens' ``.cpu()``). A token's time is
the host clock when the call that made it returned.

After the window: the peak memory is read, the cache is freed, and a
sample of the finished requests (drawn from the seed, the longest among
them) is run through the float32 reference over its prompt and served
tokens. The number compared is the widest gap by which a served token's
reference logit lies below the reference's best at its position. The
control is this same run with the configuration's ``control_policy`` in
place of its ``policy``, judged by the same check.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench.harness import traffic, weights
from perfbench.harness.trace import Stretch
from perfbench.reference import model as refm

TRIES = 5      # profiled stretches a traced run may take before it gives up
TRACE_START = 0.5     # share of the window before the profiled stretch
TRACE_SECONDS = 1.5   # the stretch's least length; it holds an admission


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def _plant(ctx, sess, vocab: int) -> None:
    """A fault under the timed path, for the harness's own tests only:
    ``token``: the join alters each request's third token where it makes it;
    ``state``: every decode step's cache writes are undone."""
    if ctx.fault == "token":
        join = sess.join_decode

        def altered(ticket):
            done = join(ticket)
            for r in sess.slots + done:
                if r is not None and len(r.out) == 3:
                    r.out[-1] = (r.out[-1] + 1) % vocab
            return done
        sess.join_decode = altered
    elif ctx.fault == "state":
        step = sess.step_fn

        def stale(params, tokens, caches, pos, *rest):
            kept = [{k: v.clone() for k, v in c.items()} for c in caches]
            nxt, logits, out = step(params, tokens, caches, pos, *rest)
            for c, old in zip(out, kept):
                for k, v in old.items():
                    c[k].copy_(v)
            return nxt, logits, out
        sess.step_fn = stale
    elif ctx.fault is not None:
        raise ValueError(f"no fault {ctx.fault!r} in serving")


def run(ctx) -> dict:
    import torch
    from repro_torch.core import execution as ex
    from repro_torch.kernels import _build
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.models.transformer import params_shape
    from repro_torch.runtime.serve_loop import Request, ServeSession
    ctx.part("imports")
    mix, dev, spans = ctx.mix, ctx.device, ctx.spans
    if dev.type == "cuda":
        _build.load("gemm")
        _build.load("flash_attention")
    ctx.part("kernels")
    params, _ = weights.make(params_shape(ctx.cfg), ctx.seed, dev)
    _sync(dev)
    ctx.part("weights")
    specs = traffic.requests(mix, ctx.seed, ctx.ref.vocab)
    sess = ServeSession(params, ctx.cfg, batch_slots=mix["batch_slots"],
                        max_len=mix["max_len"],
                        rt=RuntimeCfg(use_pallas=True),
                        policy=ex.parse_policy(ctx.conf["policy"]),
                        device=dev)
    _plant(ctx, sess, ctx.ref.vocab)
    ctx.part("session")

    info = {}                 # uid -> {"req", "submit", "times"}
    order = iter(specs)

    def admit(submit_t):
        spec = next(order, None)
        if spec is None:
            raise RuntimeError(f"the mix's pool of {mix['pool']} requests "
                               "ran out inside the window")
        req = Request(uid=spec.index, prompt=spec.prompt,
                      max_new=spec.max_new)
        with spans.span("admit", tokens=len(spec.prompt)) as s:
            sess.admit(req)
        info[req.uid] = {"req": req, "submit": submit_t,
                         "times": [s["t1"]]}

    def decode():
        active = [(i, r) for i, r in enumerate(sess.slots) if r is not None]
        with spans.span("decode", active=len(active),
                        positions=[int(sess.slot_pos[i])
                                   for i, _ in active]) as s:
            done = sess.decode_once()
        for _, r in active:
            info[r.uid]["times"].append(s["t1"])
        return [s["t1"]] * len(done)

    # set-up: the longest prompt's shapes, then every client's first
    # request and one step over full slots
    longest = max(specs, key=lambda sp: len(sp.prompt))
    warm = Request(uid=-1, prompt=longest.prompt, max_new=2)
    sess.admit(warm)
    sess.decode_once()
    sess.completed.clear()
    for _ in range(mix["clients"]):
        admit(None)
    waiting = decode()
    _sync(dev)
    spans.items.clear()
    ctx.part("warm-up")

    from perfbench.harness.bench import process_age_s
    setup_s = process_age_s()
    stretch, record, tries = None, None, 0
    t_start = time.perf_counter()
    t_stop = t_start + ctx.seconds
    while time.perf_counter() < t_stop:
        while waiting and sess.has_free_slot():
            admit(waiting.pop(0))
        waiting += decode()
        if not ctx.trace or record is not None:
            continue
        now = time.perf_counter()
        if stretch is None and tries < TRIES \
                and now >= t_start + TRACE_START * ctx.seconds:
            stretch, tries = Stretch(spans), tries + 1
            stretch.start()
        elif stretch is not None and now - stretch.t0 >= TRACE_SECONDS \
                and any(s["name"] == "admit" and s["t0"] >= stretch.t0
                        for s in spans.items):
            record = stretch.stop()
            stretch = None
    if stretch is not None:
        record = stretch.stop()
    _sync(dev)
    t_end = time.perf_counter()
    if ctx.trace:
        ctx.log(f"profiled stretches: {tries}, the last "
                + ("whole" if record is not None else "lost records"))

    window = t_end - t_start
    made = [t for i in info.values() for t in i["times"] if t > t_start]
    ctx.log("window: {} admissions ({} prompt tokens), {} decode steps, {} "
            "tokens in {:.3f} s".format(
                sum(s["name"] == "admit" for s in spans.items),
                sum(s.get("tokens", 0) for s in spans.items
                    if s["name"] == "admit"),
                sum(s["name"] == "decode" for s in spans.items), len(made),
                window))
    third = window / 3
    ctx.log("output tokens/s by third of the window: " + ", ".join(
        "{:.2f}".format(sum(t_start + k * third < t <= t_start
                            + (k + 1) * third for t in made) / third)
        for k in range(3)))
    ttft = [i["times"][0] - i["submit"] for i in info.values()
            if i["submit"] is not None]
    gaps = [(a, b) for i in info.values()
            for a, b in zip(i["times"], i["times"][1:]) if a > t_start]
    itl = [b - a for a, b in gaps]
    e2e = {"output_tok_s": len(made) / window, "setup_s": setup_s}
    if ttft:
        e2e["ttft_p90_ms"] = 1e3 * float(np.percentile(ttft, 90))
    if itl:
        e2e["itl_p95_ms"] = 1e3 * float(np.percentile(itl, 95))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if record is not None:
        inside = [s for s in spans.items if s["t0"] >= record["host_t0"]
                  and s["t1"] <= record["host_t1"]]
        record["admits"] = [s["tokens"] for s in inside
                            if s["name"] == "admit"]
        record["decodes"] = [s["positions"] for s in inside
                             if s["name"] == "decode"]
    rec = {"kind": "serve", "ref": ctx.ref, "window_s": window,
           "traced_s": spans.traced_s, "spans": spans.items,
           "itl_s": [b - a for a, b in gaps if not _in(record, a, b)],
           "stretch": record}

    finished = sorted((i["req"] for i in info.values() if i["req"].done),
                      key=lambda r: r.uid)
    del sess, waiting
    from perfbench.harness.bench import free_memory
    free_memory()
    checks, correct = check(ctx, params, finished)
    return {"e2e": e2e, "record": rec, "correct": correct,
            "checks": checks, "attempted": len(info), "failed": 0,
            "memory_peak_bytes": int(peak), "setup_parts": ctx.setup}


def _in(record, a, b) -> bool:
    """Whether (a, b) on the host's clock overlaps the profiled stretch."""
    return record is not None and b > record["host_t0"] \
        and a < record["host_t1"]


def sample(ctx, finished):
    """The requests the check reads: the longest finished one (prompt and
    served tokens), then others in an order drawn from the seed, until
    there are ``check.requests`` of them and ``check.min_tokens`` served
    tokens among them."""
    if not finished:
        return []
    want, tokens = ctx.mix["check"]["requests"], ctx.mix["check"]["min_tokens"]
    longest = max(finished, key=lambda r: (len(r.prompt) + len(r.out),
                                           -r.uid))
    rest = [r for r in finished if r is not longest]
    rng = np.random.default_rng(weights.sub_seed(ctx.seed, 2))
    chosen = [longest]
    for i in rng.permutation(len(rest)):
        if len(chosen) >= want and sum(len(r.out) for r in chosen) >= tokens:
            break
        chosen.append(rest[i])
    return chosen


def check(ctx, params, finished):
    """(checks, correct): the widest gap of the sample's served tokens
    against its limit."""
    refm.f32_matmuls()
    chosen = sample(ctx, finished)
    limit = ctx.limits["widest_gap"]
    served = sum(len(r.out) for r in chosen)
    bad = [t for r in chosen for t in r.out if not 0 <= t < ctx.ref.vocab]
    widest = float("inf")
    if chosen and not bad:
        rows = refm.served_rows(params, ctx.ref,
                                [(r.prompt, r.out) for r in chosen])
        widest = max(float(refm.gaps(rw, r.out).max())
                     for rw, r in zip(rows, chosen))
    checks = {"widest_gap": {"value": widest, "limit": limit},
              "served_tokens": {"value": served,
                                "limit": ctx.mix["check"]["min_tokens"]}}
    correct = widest <= limit and served >= ctx.mix["check"]["min_tokens"]
    return checks, bool(correct)
