"""Serving CLI of the port: continuous batching, technique switches and
the multi-tenant serving control plane.

Twin of ``repro/launch/serve.py``. Weights are random, made from ``--seed``
on the device; prompts are random tokens. Without ``--device`` everything
runs on ``cuda``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --reduced --device cpu --requests 4 --max-new 8

``--backend hopper`` (or its JAX name ``pallas``) sends every linear through
the hand-written GEMM kernel and prefill attention through the flash
kernel. ``--policy bf16:sparse24:hopper`` prunes and packs the weights 2:4
once and sends every packed linear through the packed 2:4 GEMM kernel;
``--policy auto`` lets the occupancy advisor pick (``--backend`` then
names the backend it may use); with ``--autotune`` it decides from the
calibrated artifact of ``launch/profile.py`` (``$REPRO_AUTOTUNE_DIR`` or
``build/repro_torch_autotune``). ``--paged`` serves from a pool of
``--page-size``-row pages with per-slot page tables; its tokens equal
the dense cache's. ``--temperature T`` samples (0, the default, is
greedy), with ``jax.random``'s draws from ``--seed``
(``core/prng.py``).

The control plane (``runtime/server.py``) is configured by a serialized
``ServingSpec`` (``--spec spec.json``) or by the shorthand flags
(``--partitions/--placement/--adaptive-quota/--admission/--migrate``),
which build one; ``--save-spec`` writes the effective spec. ``--tenants >
1`` with one partition goes through the ``StreamScheduler``; more than one
partition, ``--migrate``, ``--controller`` or ``--workload`` go through
the ``ServingRuntime``, whose partitions decode on lanes (CUDA streams)
of their own unless ``--no-overlap``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --reduced --device cpu --tenants 3 --admission fair_quantum
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --reduced --device cpu --tenants 3 --partitions 2 --migrate \\
      --slo latency:12 --metrics-out m.prom --trace-out t.json
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

HOPPER_BACKENDS = ("hopper", "hopper_sparse24", "hopper_paged")


def build_spec(args, policy):
    """The shorthand flag cluster as a :class:`ServingSpec` (``--spec``
    supersedes it)."""
    from repro_torch.runtime.server import (
        MigrationSpec, PartitionSpec, ServingSpec)
    quota = "adaptive" if args.adaptive_quota else None
    return ServingSpec(
        partitions=tuple(
            PartitionSpec(admission=args.admission, quota=quota)
            for _ in range(max(1, args.partitions))),
        placement=args.placement,
        batch_slots=args.slots,
        max_len=args.max_len,
        temperature=args.temperature,
        seed=args.seed,
        policy=policy,
        migration=MigrationSpec(enabled=args.migrate),
        paged=getattr(args, "paged", False),
        page_size=getattr(args, "page_size", 16),
        pages=getattr(args, "pages", None),
        overlap=not getattr(args, "no_overlap", False),
        metrics=getattr(args, "metrics_out", None) is not None,
        controller=_parse_controller(getattr(args, "controller", None)))


def _parse_controller(arg):
    from repro_torch.runtime.controller import ControllerSpec
    return ControllerSpec.parse(arg)


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--precision", default=None, choices=[None, "bf16", "fp8"])
    ap.add_argument("--policy", default=None,
                    help="execution-policy spec, e.g. 'fp8:dense:hopper', or "
                         "'auto' to resolve via the occupancy advisor "
                         "(paper §9.2) from slots/d_model/d_ff")
    ap.add_argument("--backend", default=None,
                    choices=[None, "ref", "torch", "hopper", "hopper_sparse24",
                             "hopper_paged", "jnp", "pallas",
                             "pallas_sparse24", "pallas_paged"],
                    help="matmul backend (kernels/registry.py); jnp, "
                         "pallas, pallas_sparse24 and pallas_paged are the "
                         "JAX names of torch, hopper, hopper_sparse24 and "
                         "hopper_paged")
    ap.add_argument("--paged", action="store_true",
                    help="paged serving cache (core/paging.py): per-slot "
                         "page tables over a shared pool; greedy output is "
                         "token-identical to the dense cache")
    ap.add_argument("--page-size", type=int, default=16,
                    help="token positions per cache page (must divide "
                         "--max-len)")
    ap.add_argument("--pages", type=int, default=None,
                    help="physical pool size in pages (default: dense-"
                         "equivalent capacity, slots * max_len/page_size)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sample with this temperature (0: greedy); the "
                         "draws reproduce jax.random's from --seed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tenants", type=int, default=1,
                    help="number of tenant queues; >1 routes through the "
                         "StreamScheduler (or the ServingRuntime)")
    ap.add_argument("--spec", default=None, metavar="PATH",
                    help="serialized ServingSpec (runtime/server.py); "
                         "supersedes the partition/placement/admission/"
                         "quota shorthand flags")
    ap.add_argument("--save-spec", default=None, metavar="PATH",
                    help="write the effective ServingSpec as JSON")
    ap.add_argument("--admission", default="fair_quantum",
                    choices=["fifo", "round_robin", "fair_quantum"],
                    help="[shorthand] multi-tenant admission policy")
    ap.add_argument("--partitions", type=int, default=1,
                    help="[shorthand] serving partitions; >1 serves tenants "
                         "through the ServingRuntime control plane (on one "
                         "card the partitions are logical: they share it)")
    ap.add_argument("--placement", default="spread",
                    choices=["packed", "spread", "load_aware"],
                    help="[shorthand] tenant->partition routing policy")
    ap.add_argument("--adaptive-quota", action="store_true",
                    help="[shorthand] re-derive per-tenant fair_quantum "
                         "slot caps online from Tracer.tenant_percentiles()")
    ap.add_argument("--migrate", action="store_true",
                    help="[shorthand] enable live tenant migration (the "
                         "load_aware re-route path; see MigrationSpec)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="disable lane overlap: partitions step through "
                         "the serial loop instead of OverlapPlanner-paired "
                         "dispatch on their lanes (token streams are "
                         "identical either way)")
    ap.add_argument("--telemetry", action="store_true",
                    help="record per-op/per-tenant events to a Tracer and "
                         "print the observatory summary at exit")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics-registry snapshot at exit "
                         "(.json, or Prometheus text for .prom/.txt); "
                         "implies the metrics plane (runtime/metrics.py)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export the run's telemetry as Chrome trace_event "
                         "JSON (runtime/traceview.py) — open in "
                         "chrome://tracing or https://ui.perfetto.dev")
    ap.add_argument("--slo", default=None,
                    help="SLO class for every shorthand tenant "
                         "('latency:12', 'latency:0.05@wall_s', "
                         "'throughput:1.5', 'batch:0.9')")
    ap.add_argument("--autotune", action="store_true",
                    help="load the persistent autotune artifact "
                         "(launch/profile.py; $REPRO_AUTOTUNE_DIR or "
                         "build/repro_torch_autotune) and resolve policies "
                         "from calibrated thresholds")
    ap.add_argument("--controller", default=None, nargs="?", const="on",
                    metavar="SPEC",
                    help="SLO closed loop (runtime/controller.py): bare "
                         "flag for defaults, or 'interval=2,low=0.85,"
                         "hold=4' knobs")
    ap.add_argument("--workload", default=None, metavar="TRACE",
                    help="replay a WorkloadTrace JSON (launch/loadgen.py "
                         "--save-trace) through the runtime instead of "
                         "the synthetic --requests stream")
    return ap


def main(argv=None):
    args = make_parser().parse_args(argv)

    from repro_torch.configs import get_arch, get_reduced
    from repro_torch.core import autotune, execution as ex
    from repro_torch.models import init_params
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.runtime import telemetry
    from repro_torch.runtime.scheduler import StreamScheduler
    from repro_torch.runtime.serve_loop import (
        Request, ServeSession, resolve_device)
    from repro_torch.runtime.server import ServingRuntime, ServingSpec

    device = resolve_device(args.device)
    store = autotune.install() if args.autotune else None
    if args.autotune:
        print(f"[serve] autotune artifact "
              f"{'loaded: ' + store.path if store else 'not found'}")
    want_tracer = args.telemetry or args.metrics_out or args.trace_out
    tracer = telemetry.Tracer(phases=True) if want_tracer else None
    if tracer is not None:
        telemetry.set_tracer(tracer)    # observe policy resolutions

    cfg = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    if args.precision:
        cfg = dataclasses.replace(cfg, precision=args.precision)
    backend = ex.BACKEND_ALIASES.get(args.backend, args.backend)
    if args.policy == "auto":
        policy = "auto"        # the session resolves it, with auto_backend
        use_pallas = backend in HOPPER_BACKENDS
    else:
        policy = ex.parse_policy(args.policy or "", base=ex.ExecutionPolicy(
            precision=cfg.precision,
            sparsity="sparse24" if cfg.sparsity_24 else "dense"))
        if backend:
            policy = dataclasses.replace(policy, backend=backend)
        use_pallas = policy.backend in HOPPER_BACKENDS
    rt = RuntimeCfg(use_pallas=use_pallas)
    resolved_under = policy.backend if policy != "auto" \
        else backend or ex.default_backend()
    note = store and store.backend_note(resolved_under)
    if note:
        print(f"[serve] {note}")

    if args.spec:
        spec = ServingSpec.load(args.spec)
        print(f"[serve] spec loaded: {args.spec} "
              f"({spec.n_partitions} partitions, {spec.placement}, "
              f"migration={'on' if spec.migration.enabled else 'off'})")
        if args.metrics_out and not spec.metrics:
            spec = dataclasses.replace(spec, metrics=True)
        if args.controller:
            spec = dataclasses.replace(
                spec, controller=_parse_controller(args.controller))
    else:
        spec = build_spec(args, policy)
    if args.save_spec:
        print(f"[serve] spec written: {spec.save(args.save_spec)}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=device)

    rng = np.random.default_rng(args.seed)
    requests = []
    for uid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=(args.prompt_len,)).astype(np.int32)
        requests.append(Request(uid=uid, prompt=prompt,
                                max_new=args.max_new))

    use_runtime = (args.spec is not None or spec.n_partitions > 1
                   or spec.migration.enabled or args.workload is not None
                   or args.controller is not None)
    if use_runtime:
        runtime = ServingRuntime(
            params, cfg, spec, rt=rt, device=device,
            session_kw={"auto_backend": backend, "verbose_policy": True})
        # timed region starts after construction: session set-up (policy
        # resolution, the 2:4 pack, cache allocation) is not serving time
        t0 = time.time()
        if args.workload:
            from repro_torch.runtime.workload import WorkloadTrace, run_trace
            wtrace = WorkloadTrace.load(args.workload)
            print(f"[serve] workload trace: {args.workload} "
                  f"({len(wtrace.events)} arrivals / "
                  f"{len(wtrace.tenant_ids())} tenants over "
                  f"{wtrace.steps} steps)")
            done = run_trace(runtime, wtrace)
            args.requests = len(wtrace.events)
        else:
            tenant_ids = [t.id for t in spec.tenants]
            if not tenant_ids:
                tenant_ids = [f"tenant{i}"
                              for i in range(max(args.tenants, 1))]
                for tid in tenant_ids:
                    part = runtime.add_tenant(tid, slo=args.slo)
                    print(f"[serve] {tid} -> partition {part} "
                          f"({spec.placement})")
            for uid, req in enumerate(requests):
                runtime.submit(tenant_ids[uid % len(tenant_ids)], req)
            done = runtime.drain()
        if runtime.controller is not None:
            counts = runtime.controller.counts()
            print(f"[serve] controller: checks "
                  f"{runtime.controller.checks} · "
                  + ", ".join(f"{a}:{n}" for a, n in counts.items()))
        print(runtime.report().summary())
        if args.telemetry:
            print(runtime.merged_tracer().summary())
            print(tracer.summary())
        if args.metrics_out and runtime.metrics is not None:
            print(f"[serve] metrics written: "
                  f"{runtime.metrics.save(args.metrics_out)}")
        if args.trace_out:
            from repro_torch.runtime import traceview
            merged = telemetry.Tracer.merge(*runtime.tracers, tracer)
            print(f"[serve] trace written: "
                  f"{traceview.export_chrome_trace(merged, args.trace_out)}"
                  " (open in chrome://tracing or ui.perfetto.dev)")
        dt = time.time() - t0
        total_new = sum(len(r.out) for r in done)
        print(f"[serve] {len(done)}/{args.requests} requests, "
              f"{total_new} tokens in {dt:.1f}s "
              f"({total_new / max(dt, 1e-9):.1f} tok/s aggregate) "
              f"on {device}, temperature {spec.temperature}")
        return 0

    sess = ServeSession(params, cfg, batch_slots=args.slots,
                        max_len=args.max_len, rt=rt,
                        temperature=args.temperature, seed=args.seed,
                        policy=policy, auto_backend=backend,
                        verbose_policy=True, telemetry=tracer,
                        paged=args.paged, page_size=args.page_size,
                        pages=args.pages, device=device)
    registry = None
    if args.metrics_out:
        from repro_torch.runtime.metrics import MetricsSink
        registry = MetricsSink().attach(tracer).registry
    if args.paged:
        print(f"[serve] paged cache: page_size={sess.page_size} "
              f"pages={sess.pages}")
    t0 = time.time()
    if args.tenants > 1:
        # requests dealt round-robin over tenant queues; the session
        # policy becomes each tenant's slot quota only when its stream
        # budget was chosen ('auto' or an explicit streams= token)
        quota = "adaptive" if args.adaptive_quota else None
        sched = StreamScheduler(sess, admission=args.admission,
                                tracer=tracer, quota=quota)
        tpol = None
        if isinstance(sess.policy, ex.ExecutionPolicy) and (
                args.policy == "auto" or "streams=" in (args.policy or "")):
            tpol = sess.policy
        for i in range(args.tenants):
            sched.add_tenant(f"tenant{i}", policy=tpol, slo=args.slo)
        for uid, req in enumerate(requests):
            sched.submit(f"tenant{uid % args.tenants}", req)
        done = sched.run()
        print(sched.report().summary())
    else:
        for req in requests:
            sess.submit(req)
        done = sess.run()
    dt = time.time() - t0
    total_new = sum(len(r.out) for r in done)
    print(f"[serve] {len(done)}/{args.requests} requests, {total_new} tokens "
          f"in {dt:.1f}s ({total_new / max(dt, 1e-9):.1f} tok/s aggregate) "
          f"on {device}, temperature {args.temperature}")
    for r in done[:4]:
        print(f"  req {r.uid}: {len(r.out)} new tokens, first 8: {r.out[:8]}")
    if args.telemetry and tracer is not None:
        print(tracer.summary())
    if registry is not None:
        print(f"[serve] metrics written: {registry.save(args.metrics_out)}")
    if args.trace_out and tracer is not None:
        from repro_torch.runtime import traceview
        print(f"[serve] trace written: "
              f"{traceview.export_chrome_trace(tracer, args.trace_out)}"
              " (open in chrome://tracing or ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
