"""End-to-end training CLI of the port.

Twin of ``repro/launch/train.py``: the data pipeline (with its cursor in
the checkpoint), AdamW with FP32 masters, the FP8 / 2:4 switches and the
execution policy, async checkpoints, the straggler monitor, the heartbeat
and supervised restart. Weights are random, made from ``--seed`` on the
device; batches come from ``SyntheticLM`` (the reference's, bit for bit).
Without ``--device`` everything runs on ``cuda``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --reduced --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --reduced --device cuda --policy fp8:dense:hopper --checkpoint-dir ck

``--backend hopper`` (or its JAX name ``pallas``) runs every linear's
forward on the hand-written GEMM kernel, its backward through the torch
reference. ``--autotune`` installs the calibrated artifact of
``launch/profile.py`` (``$REPRO_AUTOTUNE_DIR`` or
``build/repro_torch_autotune``) before the policy is resolved.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

BACKENDS = ("ref", "torch", "hopper", "hopper_sparse24", "jnp", "pallas",
            "pallas_sparse24")


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--total-steps", type=int, default=1000,
                    help="LR-schedule horizon (fixed so resumed runs see "
                         "the identical schedule regardless of --steps)")
    ap.add_argument("--precision", default=None, choices=[None, "bf16", "fp8"])
    ap.add_argument("--sparsity-24", action="store_true")
    ap.add_argument("--backend", default=None, choices=[None, *BACKENDS],
                    help="matmul backend (kernels/registry.py), default "
                         "torch; jnp, pallas and pallas_sparse24 are the JAX "
                         "names of torch, hopper and hopper_sparse24")
    ap.add_argument("--policy", default=None,
                    help="full execution-policy spec, e.g. 'fp8:dense:"
                         "hopper' (overrides --precision/--sparsity-24/"
                         "--backend pieces it names)")
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "bf16", "int8_ef"])
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--supervise", action="store_true")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at-step", type=int, default=0,
                    help="(testing) crash at this step to exercise restart")
    ap.add_argument("--telemetry", action="store_true",
                    help="record each step's span and its forward, backward "
                         "and optimizer phases; print the telemetry "
                         "summary at exit")
    ap.add_argument("--autotune", action="store_true",
                    help="load the persistent autotune artifact "
                         "(launch/profile.py) so policy resolution uses "
                         "calibrated thresholds")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap


def run_once(args) -> int:
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_arch, get_reduced
    from repro_torch.core import autotune, execution as ex
    from repro_torch.core.concurrency import resolve_device
    from repro_torch.data.pipeline import Prefetcher, SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.optim import adamw
    from repro_torch.runtime import telemetry
    from repro_torch.runtime import train_loop as tl
    from repro_torch.runtime.fault_tolerance import Heartbeat, StepMonitor

    device = resolve_device(args.device)
    store = autotune.install() if args.autotune else None
    if args.autotune:
        print(f"[train] autotune artifact "
              f"{'loaded: ' + store.path if store else 'not found'}")
    tracer = telemetry.Tracer(phases=True) if args.telemetry else None

    cfg = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    if args.precision:
        cfg = dataclasses.replace(cfg, precision=args.precision)
    if args.sparsity_24:
        cfg = dataclasses.replace(cfg, sparsity_24=True)

    policy = None
    if args.policy or args.backend:
        base = ex.ExecutionPolicy(
            precision=cfg.precision,
            sparsity="sparse24" if cfg.sparsity_24 else "dense")
        policy = ex.parse_policy(args.policy or "", base=base)
        if args.backend:
            policy = dataclasses.replace(
                policy, backend=ex.BACKEND_ALIASES.get(args.backend,
                                                       args.backend))
        print(f"[train] execution policy: {policy.spec()}")
    note = store and store.backend_note(
        policy.backend if policy else ex.default_backend())
    if note:
        print(f"[train] {note}")

    rt = RuntimeCfg(chunk_q=min(64, args.seq), chunk_kv=min(64, args.seq),
                    ssm_chunk=32)
    # schedule derives only from --total-steps: a resumed run must see the
    # exact same lr curve as an uninterrupted one (bitwise replay)
    opt_cfg = adamw.AdamWConfig(learning_rate=args.lr,
                                total_steps=args.total_steps,
                                warmup_steps=min(20, args.total_steps // 50))

    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=device)
    state = tl.init_state(params, opt_cfg, args.grad_compress)
    step0 = 0

    ckpt = None
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir)
        if args.resume:
            restored = ckpt.restore_latest(state)
            if restored is not None:
                step0, state, extra = restored
                data.cursor.step = int(extra.get("data_step", step0))
                print(f"[train] resumed from step {step0}")

    train_step = tl.make_train_step(
        cfg, opt_cfg, rt, grad_compress=args.grad_compress,
        microbatch=args.microbatch, policy=policy, telemetry=tracer)

    monitor = StepMonitor()
    hb = None
    if args.checkpoint_dir:
        hb = Heartbeat(args.checkpoint_dir + "/heartbeat.json",
                       hang_timeout_s=0)

    data.cursor.step = step0
    prefetch = Prefetcher(data, depth=2)
    t_start = time.time()
    losses = []
    try:
        for step in range(step0, args.steps):
            if args.fail_at_step and step == args.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in next(prefetch).items()}
            t0 = time.time()
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])          # waits for the step
            st = monitor.record(step, time.time() - t0)
            losses.append(loss)
            if hb:
                hb.beat(step)
            if step % args.log_every == 0 or step == args.steps - 1:
                flag = " STRAGGLER" if st.is_straggler else ""
                print(f"[train] step={step} loss={loss:.4f} "
                      f"dt={st.duration_s*1e3:.1f}ms "
                      f"ewma={st.ewma_s*1e3:.1f}ms{flag}")
            if not np.isfinite(loss):
                print("[train] non-finite loss; aborting")
                return 1
            if ckpt and step > 0 and step % args.checkpoint_every == 0:
                # the state after batch `step` resumes at step + 1; the
                # reference labels it `step`, so its resume runs that
                # batch a second time
                ckpt.save(step + 1, state, extra={"data_step": step + 1})
    finally:
        prefetch.close()
        if hb:
            hb.close()
        if ckpt:
            ckpt.wait()
    if ckpt:
        ckpt.save(args.steps, state, extra={"data_step": args.steps},
                  blocking=True)
    dt = time.time() - t_start
    print(f"[train] done: {args.steps - step0} steps in {dt:.1f}s on "
          f"{device}; loss {losses[0]:.4f} -> {losses[-1]:.4f}"
          if losses else f"[train] done: no steps left after {step0}")
    if tracer is not None:
        print(tracer.summary())
    return 0


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.supervise:
        from repro_torch.runtime.fault_tolerance import supervise

        def attempt():
            a = argparse.Namespace(**vars(args))
            a.resume = True
            a.supervise = False
            a.fail_at_step = 0 if args.resume else args.fail_at_step
            # set before the run: the reference sets it after, which a
            # crashed run never reaches, so it injects the failure again
            # on every attempt and never recovers
            args.resume = True
            return run_once(a)
        return supervise(attempt, max_restarts=args.max_restarts)
    return run_once(args)


if __name__ == "__main__":
    raise SystemExit(main())
