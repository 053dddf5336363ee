"""Live serving dashboard: ``top`` for the ServingRuntime.

Twin of ``repro/launch/top.py``. A refresh-loop terminal view over a
running :class:`~repro_torch.runtime.server.ServingRuntime` — per-partition
occupancy and backlog, page-pool utilization, per-tenant progress /
fairness / SLO attainment, and the metrics-registry counters, re-rendered
in place every interval. :func:`render` is a pure report→text function
(the tests drive it headless); :func:`watch` owns the ANSI refresh loop;
``main`` builds a reduced-model runtime (random weights from ``--seed``
on ``--device``, ``cuda`` by default) with synthetic staggered tenant
traffic so the dashboard has something live to show:

  PYTHONPATH=src python -m repro_torch.launch.top --reduced --device cpu \\
      --partitions 2 --tenants 3 --requests 12 --paged --slo latency:12

Non-interactive consumers (CI, logs) pass ``--once`` to print a single
frame per drain instead of cursor control.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

BAR_FILL = "█"
BAR_EMPTY = "·"


def _bar(frac: float, width: int = 16) -> str:
    frac = max(0.0, min(1.0, float(frac)))
    n = int(round(frac * width))
    return BAR_FILL * n + BAR_EMPTY * (width - n)


def _fmt_att(att: Optional[float]) -> str:
    return " n/a" if att is None else f"{att * 100:3.0f}%"


def render(runtime, report=None, *, clock: Optional[float] = None) -> str:
    """One dashboard frame as text (no cursor control — the caller owns
    the terminal). Folds the current report into the runtime's metrics
    registry when one is attached (``ServingSpec(metrics=True)``)."""
    rep = report if report is not None else runtime.report()
    lines: List[str] = []
    tick = f" t={clock:.1f}s" if clock is not None else ""
    lines.append(
        f"repro-top · {rep.n_partitions} partition(s) "
        f"({rep.placement}, {rep.admission}/{rep.quota}) · "
        f"step {rep.steps}{tick}")
    lines.append(
        f"  tokens {rep.tokens_out} · pending {runtime.pending()} · "
        f"active {runtime.n_active} · fairness {rep.fairness:.3f} "
        f"[{_bar(rep.fairness)}] · migrations {rep.migrations}")
    lines.append("")

    # -- partitions ---------------------------------------------------------
    lines.append("  PART  POLICY            TEN  BACKLOG  SLOTS  FILL"
                 "              PAGES")
    for i, sched in enumerate(runtime.schedulers):
        sess = runtime.sessions[i]
        pol = rep.policies[i] if i < len(rep.policies) else ""
        backlog = sched.pending()
        active = sess.n_active
        fill = runtime.tracers[i].mean_fill()
        fill_s = f"{fill:5.1f}x" if fill is not None else "  n/a "
        slot_frac = active / max(1, sess.batch_slots)
        if getattr(sess, "pager", None) is not None:
            st = sess.pager.stats()
            pages = (f"{st['pages_in_use']}/{st['pages']} "
                     f"util {st['utilization'] * 100:3.0f}% "
                     f"frag {st['fragmentation'] * 100:3.0f}%")
        else:
            pages = "dense"
        lines.append(
            f"  p{i:<4} {(pol or 'ambient'):<17} "
            f"{len(sched.tenants):>3}  {backlog:>7}  "
            f"{active}/{sess.batch_slots:<3}  "
            f"{fill_s} [{_bar(slot_frac, 8)}]  {pages}")
    lines.append("")

    # -- tenants ------------------------------------------------------------
    ctrl = getattr(runtime, "controller", None)
    lines.append("  TENANT      P   DONE/SUB    TOK   TURN   SPEC"
                 "          SLO                    ATTAIN       CTRL")
    for t in rep.tenants:
        slo = t.slo or "-"
        att_bar = _bar(t.slo_attainment or 0.0, 10) if t.slo else "-" * 10
        mig = f" *m{t.migrations}" if t.migrations else ""
        if t.effective_tokens_per_step is not None:
            acc = f"{t.acceptance_rate * 100:3.0f}%" \
                if t.acceptance_rate is not None else " n/a"
            spec = f"{t.effective_tokens_per_step:4.2f}x/{acc}"
        else:
            spec = "-"
        # SLO trend arrow from the controller's recent-attainment delta:
        # ^ improving, v degrading, = steady, blank when untracked.
        trend = ctrl.trend_arrow(t.tenant_id) if ctrl is not None else ""
        lines.append(
            f"  {t.tenant_id:<11} {t.partition:>1}  "
            f"{t.completed:>4}/{t.submitted:<4}  {t.tokens_out:>5}  "
            f"{t.mean_turnaround_steps:5.1f}   {spec:<12}  {slo:<21} "
            f"{_fmt_att(t.slo_attainment)} [{att_bar}] {trend:<2}{mig}")

    # -- SLO controller ------------------------------------------------------
    if ctrl is not None:
        counts = ctrl.counts()
        acted = ", ".join(f"{a}:{n}" for a, n in counts.items())
        lines.append("")
        lines.append(f"  CTRL  checks {ctrl.checks} · frozen now "
                     f"{ctrl.frozen_now()} · {acted}")

    # -- metrics registry ---------------------------------------------------
    if runtime.metrics is not None:
        snap = runtime.metrics.snapshot()
        ev = snap.get("repro_events_total", {}).get("series", {})
        if ev:
            strip = "{}\"'"
            parts = [(k.split("=")[-1].strip(strip), v)
                     for k, v in sorted(ev.items())]
            tot = ", ".join(f"{name}:{int(v)}" for name, v in parts)
            lines.append("")
            lines.append(f"  events: {tot}")
        drop = snap.get("repro_events_dropped_total", {}).get("series", {})
        if drop:
            lines.append(f"  dropped: {sum(drop.values()):.0f} "
                         "(tracer ring evictions — raise tracer_capacity)")
    return "\n".join(lines)


def watch(runtime, *, interval_s: float = 0.5, max_steps: int = 100_000,
          out=None, once: bool = False,
          on_tick=None) -> int:
    """Drive the runtime to drain, re-rendering the dashboard every
    ``interval_s`` of wall time (ANSI in-place refresh unless ``once``) to
    ``out`` (``sys.stdout`` at the call). ``on_tick(runtime, step)`` runs
    before each refresh — the demo uses it to stagger synthetic arrivals.
    Returns total steps driven."""
    out = sys.stdout if out is None else out
    t0 = time.perf_counter()
    last = 0.0
    steps = 0

    def refresh():
        frame = render(runtime, clock=time.perf_counter() - t0)
        if once:
            print(frame, file=out)
        else:
            # home + clear-below keeps the frame flicker-free
            print("\x1b[H\x1b[J" + frame, file=out, flush=True)

    if not once:
        print("\x1b[2J", end="", file=out)      # initial clear
    while (runtime.pending() or runtime.n_active
           or runtime._draining) and steps < max_steps:
        if on_tick is not None:
            on_tick(runtime, steps)
        runtime.step()
        steps += 1
        now = time.perf_counter() - t0
        if now - last >= interval_s:
            last = now
            refresh()
    refresh()
    return steps


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="live ServingRuntime dashboard (synthetic traffic)")
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--partitions", type=int, default=2)
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--slo", default=None,
                    help="SLO class for every synthetic tenant "
                         "(e.g. 'latency:12', 'throughput:1.5', 'batch')")
    ap.add_argument("--interval", type=float, default=0.5,
                    help="refresh interval in seconds")
    ap.add_argument("--once", action="store_true",
                    help="no cursor control: print one frame per refresh "
                         "(logs / CI)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_arch, get_reduced
    from repro_torch.core.concurrency import resolve_device
    from repro_torch.models import init_params
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.runtime.serve_loop import Request
    from repro_torch.runtime.server import ServingRuntime, ServingSpec

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=device)
    spec = ServingSpec.from_dict({
        "partitions": max(1, args.partitions),
        "batch_slots": args.slots, "max_len": args.max_len,
        "paged": args.paged, "page_size": args.page_size,
        "metrics": True,
        "tenants": [{"id": f"tenant{i}", "slo": args.slo}
                    for i in range(max(1, args.tenants))],
    })
    runtime = ServingRuntime(params, cfg, spec, device=device,
                             rt=RuntimeCfg(ssm_chunk=16))

    rng = np.random.default_rng(args.seed)
    backlog = [Request(uid=uid,
                       prompt=rng.integers(
                           0, cfg.vocab_size,
                           size=(args.prompt_len,)).astype(np.int32),
                       max_new=args.max_new)
               for uid in range(args.requests)]
    tenant_ids = [t.id for t in spec.tenants]
    # staggered arrivals: a couple of requests every few steps, so the
    # dashboard shows queues moving instead of one pre-loaded burst
    arrivals = {uid: (uid // 2) * 2 for uid in range(len(backlog))}

    def on_tick(rt_, step):
        for req in list(backlog):
            if arrivals[req.uid] <= step:
                rt_.submit(tenant_ids[req.uid % len(tenant_ids)], req)
                backlog.remove(req)

    # seed the first arrivals so the drain loop has pending work
    on_tick(runtime, 0)
    steps = watch(runtime, interval_s=args.interval, once=args.once,
                  on_tick=on_tick)
    print(f"\n[top] drained in {steps} steps on {device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
