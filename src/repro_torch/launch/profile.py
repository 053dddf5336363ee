"""Calibration-sweep CLI: measure this machine's execution behaviour,
persist the autotune artifact, print a characterization report.

Twin of ``repro/launch/profile.py``. Runs a short occupancy sweep (Fig-2
methodology) and tile-latency probe (Table-3 methodology) on the card
(``--device cuda``, the default) or the CPU (``--device cpu``), folds the
measurements into the persistent
:class:`repro_torch.core.autotune.AutotuneStore`, re-derives the
FP8-demotion occupancy threshold from the samples, and shows how
``resolve_policy``'s decisions change under the calibrated advisor.

  PYTHONPATH=src python -m repro_torch.launch.profile --quick --device cpu \\
      --artifact-dir /tmp/cal
  PYTHONPATH=src python -m repro_torch.launch.profile --reset --quick

The sweeps run under ``--backend``, by default the module default
``torch``, which upcasts to f32 and does not use the tensor cores (the
full mode's ``fp32`` points run there). A calibration of the card's own
GEMM, kernel A, takes ``--backend hopper``; kernel A takes no f32, so the
full mode leaves ``fp32`` out there. On the card a point is timed by
device time (``core/characterization._time_fn``).

  PYTHONPATH=src python -m repro_torch.launch.profile --reset --backend hopper

The artifact (``autotune.json``) lives in ``$REPRO_AUTOTUNE_DIR`` or
``build/repro_torch_autotune``; every later run that calls
``autotune.install()`` (or ``launch/{train,serve}.py --autotune``) picks
it up. Its samples and thresholds name the backend they were measured
under: ``serve``/``train --autotune`` say when it is not the backend their
policy resolves under, and a run under one backend does not merge into an
artifact measured under another (``--reset`` or another
``--artifact-dir``).
"""
from __future__ import annotations

import argparse
import time


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small sweep (fewer shapes, 1 timing iter); "
                         "seconds instead of minutes")
    ap.add_argument("--artifact-dir", default=None,
                    help="override the autotune artifact directory "
                         "($REPRO_AUTOTUNE_DIR / build/repro_torch_autotune)")
    ap.add_argument("--reset", action="store_true",
                    help="discard any existing artifact before measuring")
    ap.add_argument("--iters", type=int, default=None,
                    help="timing iterations per point (default: 1 quick, "
                         "3 full)")
    ap.add_argument("--no-save", action="store_true",
                    help="measure and report only; leave the artifact "
                         "untouched")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--backend", default=None,
                    help="matmul backend the sweeps run under (default: "
                         "the module default, torch; hopper: kernel A)")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from repro_torch.core import autotune, concurrency as cc, execution as ex
    from repro_torch.core.characterization import (
        latency_probe, occupancy_sweep, occupancy_threshold)
    from repro_torch.runtime import telemetry

    device = cc.resolve_device(args.device)
    backend = ex.BACKEND_ALIASES.get(args.backend, args.backend) \
        or ex.default_backend()
    store = autotune.AutotuneStore(args.artifact_dir)
    if args.reset:
        store.reset()
        print(f"[profile] reset artifact at {store.path}")
    elif store.load():
        if store.backends() - {backend}:
            print(f"[profile] {store.path} holds samples measured under "
                  f"{sorted(store.backends())}, not {backend!r}: pass "
                  "--reset or another --artifact-dir")
            return 2
        print(f"[profile] merged existing artifact "
              f"({len(store.blocks)} blocks, {len(store.samples)} samples)")

    tracer = telemetry.Tracer()
    prev = telemetry.set_tracer(tracer)
    prev_backend = ex.default_backend()
    iters = args.iters or (1 if args.quick else 3)
    n_cores = cc.detect_core_count()
    t0 = time.time()
    try:
        ex.set_default_backend(backend)
        if args.quick:
            tile_counts, k = (1, 2, 4), 128
            precisions = ("bf16", "fp8")
            tile_shapes = ((128, 128, 128), (128, 128, 256))
            chain = 2
        else:
            tile_counts, k = (1, 2, 4, 8, 16), 256
            # kernel A takes no f32 operands
            precisions = ("bf16", "fp8") if backend in ex.KERNEL_BACKENDS \
                else ("fp32", "bf16", "fp8")
            tile_shapes = ((128, 128, 128), (256, 256, 128),
                           (128, 128, 256), (256, 256, 256))
            chain = 8

        print(f"[profile] occupancy sweep: tiles={tile_counts} "
              f"precisions={precisions} iters={iters} on {device} "
              f"(backend {ex.default_backend()})")
        occ = occupancy_sweep(tile_counts=tile_counts, k=k, n=k,
                              precisions=precisions, iters=iters,
                              device=device)
        store.add_records(occ, backend=backend)

        print(f"[profile] tile-latency probe: {len(tile_shapes)} shapes, "
              f"chain={chain}")
        lat = latency_probe(tile_shapes=tile_shapes, precisions=precisions,
                            chain=chain, iters=iters, device=device)
        ex.seed_cache_from_records(lat)      # refine this process too
        store.add_records(lat, backend=backend)
    finally:
        telemetry.set_tracer(prev)
        ex.set_default_backend(prev_backend)

    thresholds = store.calibrate(n_cores=n_cores)
    saved = None if args.no_save else store.save()

    # ---- report ----------------------------------------------------------
    print(f"\n[profile] characterization ({time.time() - t0:.1f}s, "
          f"n_cores={n_cores})")
    th90 = occupancy_threshold(occ, frac=0.9)
    print("  tiles to 90% of best throughput: " + ", ".join(
        f"{p}={t}" for p, t in sorted(th90.items())))
    if "knee_tiles" in thresholds:
        print(f"  measured FP8 knee: {thresholds['knee_tiles']:g} tiles "
              f"-> demote below fill {thresholds['demote_below_fill']:.4g}"
              f"x cores (prior: "
              f"{cc.OccupancyAdvisor.BF16_TILE_THRESHOLD}x)")
    else:
        print("  no comparable fp8/bf16 samples; thresholds keep priors")
    print(f"  store: {len(store.blocks)} block entries, "
          f"{len(store.samples)} samples")
    print("  " + tracer.summary(n_cores=n_cores).replace("\n", "\n  "))

    for line in resolve_lines(store, thresholds, n_cores, backend):
        print(line)
    if saved:
        print(f"[profile] artifact written: {saved}")
    else:
        print("[profile] --no-save: artifact not written")
    return 0


def resolve_lines(store, thresholds, n_cores, backend=None):
    """``resolve_policy`` under ``backend`` (default: the module default)
    with the prior and the calibrated advisor, below the knee and at it
    (the knee, or ``n_cores`` tiles without one)."""
    from repro_torch.core import concurrency as cc, execution as ex
    cal = store.make_advisor(n_cores=n_cores)
    prior = cc.OccupancyAdvisor(n_cores=n_cores)
    demo_tiles = int(thresholds.get("knee_tiles", n_cores))
    lines = []
    for label, tiles in (("below-knee", max(1, demo_tiles // 2)),
                         ("at-knee", demo_tiles)):
        m = 128 * max(1, tiles)
        p0 = ex.resolve_policy(m, 4096, 128, precision="fp8",
                               backend=backend, advisor=prior)
        p1 = ex.resolve_policy(m, 4096, 128, precision="fp8",
                               backend=backend, advisor=cal)
        flip = "  <-- calibration changed the decision" \
            if p0.precision != p1.precision else ""
        lines.append(f"  resolve[{label}, {tiles} tiles]: prior={p0.spec()} "
                     f"calibrated={p1.spec()}{flip}")
    return lines


if __name__ == "__main__":
    raise SystemExit(main())
