"""Perf variants: trace a cell under a named variant and read its roofline.

Twin of ``repro/launch/perf.py``:

  python -m repro_torch.launch.perf --arch llama3-405b --shape decode_32k \\
      --variant baseline,decode_2d_tp --out build/perf_torch.jsonl

Variants (hypothesis → change), the reference's eleven:
  baseline         — the dry-run's configuration
  fp8              — FP8 matmuls (E4M3 operands, f32 accumulation)
  fp8_sparse       — FP8 + 2:4 pruning
  decode_2d_tp     — decode activations replicate the batch and shard d on
                     "data": matmuls contract against resident 2-D weight
                     shards instead of gathering the weights
  moe_gather       — gather/scatter MoE dispatch (no one-hot dispatch FLOPs)
  moments_bf16     — bf16 AdamW moments (train-cell memory)
  no_seq_shard     — ablation: no Megatron-SP activation sharding
  grad_bf16        — bf16 gradient compression
  remat_dots       — keep the linears' outputs (``remat="dots"``)
  fsdp_only        — no TP: the batch over both axes, weights ZeRO-3
  fsdp_only_fp8    — fsdp_only with fp8 weights

Where the reference monkeypatches ``adamw.AdamWConfig`` for
``moments_bf16``, the port hands ``lower_train`` an explicit optimizer
config. ``--backend`` takes the port's registry names (``ref``, ``torch``,
``hopper``, ``hopper_sparse24``); under a kernel backend each kernel call
is costed as that kernel (``kernels/_build.meta_result``), which takes
whole tensors, so it runs on a one-device mesh only (``--mesh 1x1``): on
the production mesh such a variant is recorded ``ok: false`` with the
reason. ``--mesh DxM`` traces over a (data, model) mesh of that shape
instead of the production one. The CLI exits 1 if any variant failed.
``run_variant(..., use_pallas=True)`` (``RuntimeCfg.use_pallas``) routes
the prefill attention through kernel B, costed so too; it has no
backward, so train cells refuse it, as the reference's ``jax.grad``
through a ``pallas_call`` does.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs import get_arch, get_shape
from repro_torch.core import execution as ex
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as sh


@dataclasses.dataclass
class Variant:
    name: str
    cfg_fn: Callable = lambda c: c
    rt_fn: Callable = lambda r: r
    decode_2d_tp: bool = False
    opt_moments_bf16: bool = False


VARIANTS: Dict[str, Variant] = {
    "baseline": Variant("baseline"),
    "fp8": Variant(
        "fp8", cfg_fn=lambda c: dataclasses.replace(c, precision="fp8")),
    "fp8_sparse": Variant(
        "fp8_sparse", cfg_fn=lambda c: dataclasses.replace(
            c, precision="fp8", sparsity_24=True)),
    "decode_2d_tp": Variant("decode_2d_tp", decode_2d_tp=True),
    "moe_gather": Variant(
        "moe_gather",
        rt_fn=lambda r: dataclasses.replace(r, moe_gather_dispatch=True)),
    "moments_bf16": Variant("moments_bf16", opt_moments_bf16=True),
    "no_seq_shard": Variant("no_seq_shard"),
    "grad_bf16": Variant("grad_bf16"),       # bf16 gradient reduction
    "remat_dots": Variant(                   # keep the linears' outputs
        "remat_dots", cfg_fn=lambda c: dataclasses.replace(c, remat="dots")),
    "fsdp_only": Variant("fsdp_only"),       # no TP: batch over both axes
    "fsdp_only_fp8": Variant(                # ZeRO-3 + fp8 weights
        "fsdp_only_fp8",
        cfg_fn=lambda c: dataclasses.replace(c, precision="fp8")),
}

BACKENDS = ("ref", "torch", "hopper", "hopper_sparse24")


def run_variant(arch_name: str, shape_name: str, variant_name: str,
                with_layer: bool = True, backend: Optional[str] = None,
                mesh=None, cfg=None, shape=None,
                use_pallas: bool = False) -> Dict[str, Any]:
    """Trace one cell under ``variant_name``; ``mesh`` (default the single
    pod's), ``cfg`` and ``shape`` (default the named ones) may be given
    for cut-down cells."""
    var = VARIANTS[variant_name]
    cfg = var.cfg_fn(cfg or get_arch(arch_name))
    shape = shape or get_shape(shape_name)
    rec: Dict[str, Any] = {"arch": arch_name, "shape": shape_name,
                           "variant": variant_name,
                           "backend": backend or "torch"}
    t0 = time.perf_counter()
    try:
        mesh = mesh or make_production_mesh()
        rec["chips"] = mesh.size()
        rt = dr.make_rt(cfg, mesh, shape,
                        seq_shard_acts=variant_name != "no_seq_shard")
        rt = var.rt_fn(rt)
        if backend:
            rt = dataclasses.replace(rt, policy=ex.ExecutionPolicy(
                precision=cfg.precision,
                sparsity="sparse24" if cfg.sparsity_24 else "dense",
                backend=backend))
        if use_pallas:
            rt = dataclasses.replace(rt, use_pallas=True)
        if var.decode_2d_tp:
            rt = dataclasses.replace(rt, shard_fn=sh.make_shard_fn(
                cfg, mesh, shape, decode_2d_tp=True))
        lower = dr.lower_fn(shape)
        if shape.kind == "train":
            lower = functools.partial(lower, opt_cfg=adamw.AdamWConfig(
                moments_dtype=torch.bfloat16 if var.opt_moments_bf16
                else torch.float32))
            if variant_name == "grad_bf16":
                lower = functools.partial(lower, grad_compress="bf16")
        if variant_name in ("fsdp_only", "fsdp_only_fp8"):
            rt = dataclasses.replace(rt, shard_fn=sh.make_shard_fn(
                cfg, mesh, shape, policy="fsdp_only"))
            lower = functools.partial(lower, policy="fsdp_only")
        traced, layer = lower(cfg, shape, mesh, rt, with_layer)
        dr.record(rec, cfg, shape, traced, layer, rec["chips"], True)
        r, mem = rec["roofline"], rec["memory"]
        print(f"[{arch_name} × {shape_name} × {variant_name}] "
              f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
              f"coll={r['collective_s']:.4f}s bottleneck={r['bottleneck']} "
              f"frac={r['roofline_fraction']:.4f} "
              f"mem/dev={mem['per_device_total']/2**30:.1f}GiB "
              f"trace={rec['trace_s']:.1f}s", flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure
        import traceback
        rec["ok"] = False
        rec["trace_s"] = time.perf_counter() - t0
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-1500:]
        print(f"[{arch_name} × {shape_name} × {variant_name}] FAIL "
              f"{rec['error'][:160]}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True, help=",".join(VARIANTS))
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="route every matmul through this registry backend")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="a (data, model) mesh of this shape instead of "
                    "the production one; the kernel backends need 1x1")
    ap.add_argument("--out", default="build/perf_torch.jsonl")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        shape = tuple(int(n) for n in args.mesh.lower().split("x"))
        if len(shape) != 2:
            ap.error("--mesh takes DxM, e.g. 1x1 or 16x16")
        mesh = make_mesh(shape, ("data", "model"))
    n_ok, names = 0, args.variant.split(",")
    for v in names:
        rec = run_variant(args.arch, args.shape, v, backend=args.backend,
                          mesh=mesh)
        n_ok += bool(rec["ok"])
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 0 if n_ok == len(names) else 1


if __name__ == "__main__":
    raise SystemExit(main())
