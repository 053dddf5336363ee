"""Traffic generator CLI: synthesize, save, and replay serving workloads.

Twin of ``repro/launch/loadgen.py``; the workload plane's front door
(``python -m repro_torch.launch.loadgen``). Weights are random, made from
``--model-seed`` on the device (``cuda`` unless ``--device`` names
another), so the checksum is the port's own: two runs of this CLI on one
trace print the same one, whatever ``--no-overlap`` says.

* **generate + run** — build a seed-deterministic
  :class:`~repro_torch.runtime.workload.WorkloadSpec` from flags (Zipf tenant
  popularity, poisson/bursty/diurnal arrivals, mixed length
  distributions), drive it through a :class:`ServingRuntime`, and print
  the per-tenant report plus a token checksum.
* **record** — ``--save-trace PATH`` writes the generated
  :class:`WorkloadTrace` as JSON (``--gen-only`` skips the run).
* **replay** — ``--replay PATH`` loads a saved trace and drives it
  through a fresh runtime. Traces are self-contained (prompts and
  output budgets inline), so a replay reproduces the generating run's
  committed tokens bit-for-bit — the printed
  ``tokens_checksum`` line is the equality witness CI greps for.

Examples::

    python -m repro_torch.launch.loadgen --arch llama3-8b --reduced \
        --device cpu --tenants 3 --arrival bursty --rate 1.0 --steps 40 \
        --slos batch,batch,latency:20 --controller --save-trace w.json
    python -m repro_torch.launch.loadgen --arch llama3-8b --reduced \
        --device cpu --replay w.json
"""
import argparse
import sys
import time


def _lengths(lo: int, hi: int, long_lo: int, long_hi: int,
             long_frac: float):
    from repro_torch.runtime.workload import LengthDist
    if long_frac > 0:
        return LengthDist(lo=lo, hi=hi, long_lo=long_lo, long_hi=long_hi,
                          long_frac=long_frac)
    return LengthDist(lo=lo, hi=hi)


def build_workload(args):
    from repro_torch.runtime.workload import WorkloadSpec
    slos = None
    if args.slos:
        slos = tuple(s.strip() or None for s in args.slos.split(","))
    weights = ()
    if args.weights:
        weights = tuple(float(w) for w in args.weights.split(","))
    overrides = ()
    if args.latency_max_new:
        # shorthand: every latency-class rank answers short
        lo, _, hi = args.latency_max_new.partition(":")
        dist = (int(lo), int(hi or lo))
        overrides = tuple(
            dist if slos and slos[i] and slos[i].startswith("latency")
            else None for i in range(args.tenants))
    return WorkloadSpec(
        tenants=args.tenants, zipf_s=args.zipf_s, arrival=args.arrival,
        rate=args.rate, burst_factor=args.burst_factor,
        burst_len=args.burst_len, period=args.period,
        amplitude=args.amplitude, steps=args.steps,
        prompt_len=_lengths(args.prompt_lo, args.prompt_hi, args.long_lo,
                            args.long_hi, 0.0),
        max_new=_lengths(args.new_lo, args.new_hi, args.long_lo,
                         args.long_hi, args.long_frac),
        max_new_overrides=overrides, vocab=args.vocab,
        slos=slos or (), weights=weights, seed=args.seed)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="workload generator / trace replay for the serving "
                    "runtime")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    # -- workload shape ------------------------------------------------------
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--zipf-s", type=float, default=1.1,
                    help="tenant popularity skew (0: uniform)")
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "bursty", "diurnal"])
    ap.add_argument("--rate", type=float, default=1.0,
                    help="aggregate mean arrivals per scheduler step — "
                         "the millions-of-users knob")
    ap.add_argument("--burst-factor", type=float, default=4.0)
    ap.add_argument("--burst-len", type=int, default=8)
    ap.add_argument("--period", type=int, default=64)
    ap.add_argument("--amplitude", type=float, default=0.8)
    ap.add_argument("--steps", type=int, default=64,
                    help="arrival horizon in scheduler steps")
    ap.add_argument("--prompt-lo", type=int, default=4)
    ap.add_argument("--prompt-hi", type=int, default=8)
    ap.add_argument("--new-lo", type=int, default=4)
    ap.add_argument("--new-hi", type=int, default=8)
    ap.add_argument("--long-lo", type=int, default=12)
    ap.add_argument("--long-hi", type=int, default=16)
    ap.add_argument("--long-frac", type=float, default=0.0,
                    help="long-output mixture weight for max_new")
    ap.add_argument("--latency-max-new", default=None, metavar="LO:HI",
                    help="max_new override for latency-class ranks "
                         "(interactive tenants answer short)")
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--slos", default=None,
                    help="comma list per tenant rank, e.g. "
                         "'batch,batch,latency:20' (empty entry: none)")
    ap.add_argument("--weights", default=None,
                    help="comma list of per-rank scheduler weights")
    ap.add_argument("--seed", type=int, default=0,
                    help="workload seed (traffic only — model weights "
                         "come from --model-seed so a replay reproduces "
                         "regardless of the generating seed)")
    # -- runtime -------------------------------------------------------------
    ap.add_argument("--model-seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--partitions", type=int, default=1)
    ap.add_argument("--admission", default="fifo",
                    choices=["fifo", "round_robin", "fair_quantum"])
    ap.add_argument("--controller", default=None, nargs="?", const="on",
                    metavar="SPEC",
                    help="enable the SLO closed loop (bare flag for "
                         "defaults, or 'interval=2,low=0.85' knobs)")
    ap.add_argument("--policy", default=None,
                    help="execution policy of every partition, e.g. "
                         "'bf16:dense:hopper' (default: the torch backend)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="step partitions through the serial loop instead "
                         "of on their lanes (tokens are identical)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    # -- record / replay -----------------------------------------------------
    ap.add_argument("--save-trace", default=None, metavar="PATH",
                    help="write the generated WorkloadTrace JSON")
    ap.add_argument("--replay", default=None, metavar="PATH",
                    help="load a trace instead of generating one")
    ap.add_argument("--gen-only", action="store_true",
                    help="generate + save, skip the runtime run")
    args = ap.parse_args(argv)

    from repro_torch.runtime import workload as wl
    from repro_torch.runtime.controller import ControllerSpec

    if args.replay:
        trace = wl.WorkloadTrace.load(args.replay)
        print(f"[loadgen] trace loaded: {args.replay}")
    else:
        trace = wl.generate(build_workload(args))
    per = trace.arrivals_per_tenant()
    print(f"[loadgen] {len(trace.events)} arrivals over {trace.steps} "
          f"steps · " + ", ".join(f"{t}:{n}" for t, n in per.items()))
    if args.save_trace:
        trace.save(args.save_trace)
        print(f"[loadgen] trace written: {args.save_trace}")
    if args.gen_only:
        return 0

    import torch
    from repro_torch.configs import get_arch, get_reduced
    from repro_torch.core import execution as ex
    from repro_torch.models import init_params
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.runtime.serve_loop import resolve_device
    from repro_torch.runtime.server import (
        PartitionSpec, ServingRuntime, ServingSpec)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    if trace.spec is not None and trace.spec.vocab > cfg.vocab_size:
        raise SystemExit(f"trace vocab {trace.spec.vocab} exceeds model "
                         f"vocab {cfg.vocab_size}")
    gen = torch.Generator(device=device).manual_seed(args.model_seed)
    params = init_params(cfg, gen, device=device)
    policy = ex.parse_policy(args.policy) if args.policy else None
    spec = ServingSpec(
        partitions=tuple(PartitionSpec(admission=args.admission)
                         for _ in range(max(1, args.partitions))),
        batch_slots=args.slots, max_len=args.max_len, policy=policy,
        overlap=not args.no_overlap,
        controller=ControllerSpec.parse(args.controller))
    runtime = ServingRuntime(
        params, cfg, spec, device=device,
        rt=RuntimeCfg(use_pallas=policy is not None
                      and policy.backend.startswith("hopper")))
    t0 = time.time()
    done = wl.run_trace(runtime, trace)
    dt = time.time() - t0
    print(runtime.report().summary())
    if runtime.controller is not None:
        counts = runtime.controller.counts()
        print(f"[loadgen] controller: checks "
              f"{runtime.controller.checks} · "
              + ", ".join(f"{a}:{n}" for a, n in counts.items()))
    total = sum(len(r.out) for r in done)
    print(f"[loadgen] {len(done)} requests, {total} tokens, "
          f"{runtime.step_count} steps in {dt:.1f}s")
    print(f"[loadgen] tokens_checksum={wl.token_checksum(done)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
