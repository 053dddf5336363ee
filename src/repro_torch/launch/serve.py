"""Serving driver of the port: one continuous-batching session.

Twin of ``repro/launch/serve.py``'s single-session path. Weights are random,
made from ``--seed`` on the device; prompts are random tokens.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --reduced --device cpu --requests 4 --max-new 8

``--backend hopper`` (or its JAX name ``pallas``) sends every linear through
the hand-written GEMM kernel and prefill attention through the flash
kernel. ``--policy bf16:sparse24:hopper`` prunes and packs the weights 2:4
once and sends every packed linear through the packed 2:4 GEMM kernel;
``--backend hopper_sparse24`` (``pallas_sparse24``) names the backend whose
dense entry prunes and packs per call. ``--paged`` serves from a pool of
``--page-size``-row pages (``--pages`` of them; default the dense-equivalent
capacity) with per-slot page tables; its greedy tokens equal the dense
cache's. ``--backend hopper_paged`` (``pallas_paged``) names the paged
substrate's backend, whose GEMMs are ``hopper``'s. Without ``--device``
the session runs on ``cuda``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --reduced --device cpu --policy bf16:sparse24:hopper
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --reduced --device cpu --paged --pages 24
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--policy", default=None,
                    help="execution-policy spec, e.g. 'fp8:dense:hopper'")
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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch, get_reduced
    from repro_torch.core import execution as ex
    from repro_torch.models import init_params
    from repro_torch.models.layers import RuntimeCfg
    from repro_torch.runtime.serve_loop import (
        Request, ServeSession, resolve_device)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    policy = ex.parse_policy(args.policy or "",
                             base=ex.ExecutionPolicy(precision=cfg.precision))
    if args.backend:
        policy = dataclasses.replace(
            policy, backend=ex.BACKEND_ALIASES.get(args.backend, args.backend))
    rt = RuntimeCfg(use_pallas=policy.backend in (
        "hopper", "hopper_sparse24", "hopper_paged"))

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=device)
    sess = ServeSession(params, cfg, batch_slots=args.slots,
                        max_len=args.max_len, rt=rt, policy=policy,
                        verbose_policy=True, paged=args.paged,
                        page_size=args.page_size, pages=args.pages,
                        device=device)
    if args.paged:
        print(f"[serve] paged cache: page_size={sess.page_size} "
              f"pages={sess.pages}")

    rng = np.random.default_rng(args.seed)
    for uid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=(args.prompt_len,)).astype(np.int32)
        sess.submit(Request(uid=uid, prompt=prompt, max_new=args.max_new))
    t0 = time.perf_counter()
    done = sess.run()
    dt = time.perf_counter() - t0
    total_new = sum(len(r.out) for r in done)
    print(f"[serve] {len(done)}/{args.requests} requests, {total_new} tokens "
          f"in {dt:.1f}s ({total_new / max(dt, 1e-9):.1f} tok/s aggregate) "
          f"on {device}")
    for r in done[:4]:
        print(f"  req {r.uid}: {len(r.out)} new tokens, first 8: {r.out[:8]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
