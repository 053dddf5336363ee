"""Roofline terms of the dry-run's traced steps, on the H100.

Twin of ``repro/launch/roofline.py``. Three terms per (arch × shape ×
mesh), from the per-device counts of ``launch/dryrun.py``:

  compute    = FLOPs / (chips × PEAK_FLOPS)
  memory     = bytes / (chips × HBM_BW)
  collective = wire_bytes / (chips × NVLINK_BW)

with the FLOPs, bytes and wire bytes per device times the chips, so each
term is the per-device count over one card's rate. The constants are one
H100 SXM's at 700 W, dense, from NVIDIA's H100 data sheet (the same
figures the port's kernel bounds use, ``chip_smoke.bound_ms``): 989 TFLOP/s
bf16 on the tensor cores, 3.35 TB/s of HBM3, and 450 GB/s of NVLink each
way per card (NVLink 4: 900 GB/s both ways). An 8-card host joins its
cards all to all over NVLink; a 16-wide mesh axis spans two hosts, and the
collective term prices every byte at NVLink's rate: it does not model
InfiniBand between hosts, so across hosts it is optimistic.

The reference reads its collectives from compiled HLO text; the port has
no HLO. :func:`collective_of` reads each collective that DTensor issues
while the step is traced (a ``_c10d_functional`` or ``_dtensor`` op on the
local tensors) into a :class:`Collective` of the reference's kind names and
result-shape convention: an all-gather's result is the gathered tensor, a
reduce-scatter's the scattered one. The wire formulas are the reference's.
The reference assembles its totals as ``full + (L-1) × layer`` because
its cost analysis counts a scan body once; the port's eager trace counts
every layer already, so ``assemble`` is called with ``layer=None``.

This module imports nothing of the port but torch, so ``chip_smoke.py``
loads its constants from the file itself.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

# H100 SXM at 700 W, dense data-sheet peaks: operations/s per operand type
# (f32 off the tensor cores), HBM bytes/s, NVLink bytes/s each way.
PEAK_OPS_S = {"bf16": 989e12, "e4m3": 1979e12, "e5m2": 1979e12,
              "f32": 67e12}
PEAK_FLOPS = PEAK_OPS_S["bf16"]
HBM_BW = 3.35e12
NVLINK_BW = 450e9

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "f8e4m3": 1, "f8e5m2fnuz": 1, "f8e4m3fnuz": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}


def hlo_dtype(dtype) -> str:
    """The HLO name of a torch dtype (``torch.bfloat16`` → ``"bf16"``)."""
    import torch
    return {torch.float64: "f64", torch.float32: "f32",
            torch.float16: "f16", torch.bfloat16: "bf16",
            torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
            torch.int64: "s64", torch.int32: "s32", torch.int16: "s16",
            torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred",
            torch.complex64: "c64", torch.complex128: "c128"}[dtype]


@dataclasses.dataclass
class Collective:
    kind: str
    dtype: str
    shape: Tuple[int, ...]
    group_size: int

    @property
    def result_bytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * _DTYPE_BYTES.get(self.dtype, 4)

    @property
    def wire_bytes(self) -> float:
        """Per-device bytes crossing links (ring algorithms)."""
        return self._wire(self.result_bytes)

    @property
    def wire_bytes_bf16(self) -> float:
        """Wire bytes with the element size capped at 2 B (the reference's
        TPU-wire metric; the port moves each tensor in its own type, so
        the two differ only for f32 collectives)."""
        n = 1
        for d in self.shape:
            n *= d
        return self._wire(n * min(_DTYPE_BYTES.get(self.dtype, 4), 2))

    def _wire(self, b: float) -> float:
        g = max(self.group_size, 2)
        if self.kind == "all-reduce":
            return 2.0 * (g - 1) / g * b
        if self.kind == "all-gather":          # result = gathered (full)
            return (g - 1) / g * b
        if self.kind == "reduce-scatter":      # result = scattered (1/g)
            return (g - 1) * b
        if self.kind == "all-to-all":
            return (g - 1) / g * b
        if self.kind == "collective-permute":
            return float(b)
        return float(b)


# op name (after the namespace) → the reference's kind
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_out": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
          "all_to_all_single": "all-to-all",
          "shard_dim_alltoall": "all-to-all"}


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def collective_of(func, args, out) -> Optional[Collective]:
    """The :class:`Collective` a traced op issues, or ``None`` when the op
    is none (``wait_tensor`` completes one and moves nothing). A
    collective of another kind raises: its wire bytes would be unknown."""
    ns = func.namespace
    if ns not in ("_c10d_functional", "_dtensor", "c10d_functional"):
        return None
    name = func._schema.name.split("::")[-1]
    if name in ("wait_tensor", "_wrap_tensor_autograd"):
        return None
    kind = _KINDS.get(name)
    if kind is None:
        raise NotImplementedError(f"collective {func} has no wire model")
    # (input, group_size, group) / (input, op, group_size, group) / (...,
    # group): the group's name comes last
    g = {"all-gather": lambda: args[1], "reduce-scatter": lambda: args[2]
         }.get(kind, lambda: _group_size(args[-1]))()
    return Collective(kind, hlo_dtype(out.dtype), tuple(out.shape), int(g))


def collective_wire_bytes(colls: List[Collective]) -> float:
    return sum(c.wire_bytes for c in colls)


def collective_wire_bytes_bf16(colls: List[Collective]) -> float:
    return sum(c.wire_bytes_bf16 for c in colls)


def collective_summary(colls: List[Collective]) -> Dict[str, Dict[str, float]]:
    summ: Dict[str, Dict[str, float]] = {}
    for c in colls:
        e = summ.setdefault(c.kind, {"count": 0, "wire_bytes": 0.0})
        e["count"] += 1
        e["wire_bytes"] += c.wire_bytes
    return summ


# ---------------------------------------------------------------------------
# Term assembly
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellCost:
    """Per-device costs of one traced step (every layer counted)."""
    flops: float
    bytes_accessed: float
    wire_bytes: float
    collectives: Dict[str, Dict[str, float]]
    wire_bytes_bf16: float = 0.0


@dataclasses.dataclass
class Roofline:
    """``flops``/``bytes_accessed``/``wire_bytes`` are per device; the
    formula FLOPs/(chips × peak) is applied with FLOPs = per-device ×
    chips, which reduces to per-device / peak."""
    arch: str
    shape: str
    chips: int
    flops: float                 # per-device, assembled (per step)
    bytes_accessed: float
    wire_bytes: float
    model_flops: float           # 6·N_active·D analytic (GLOBAL)
    wire_bytes_bf16: float = 0.0
    min_bytes: float = 0.0       # analytic min HBM traffic (GLOBAL; decode)
    kind: str = "train"
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    collective_bf16_s: float = 0.0

    def __post_init__(self):
        self.compute_s = (self.flops * self.chips) / (self.chips * PEAK_FLOPS)
        self.memory_s = (self.bytes_accessed * self.chips) / (self.chips
                                                              * HBM_BW)
        self.collective_s = (self.wire_bytes * self.chips) / (self.chips
                                                              * NVLINK_BW)
        self.collective_bf16_s = ((self.wire_bytes_bf16 or self.wire_bytes)
                                  * self.chips) / (self.chips * NVLINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step-time lower bound = max of overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / global FLOPs: what remat and redundancy waste."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def ideal_s(self) -> float:
        """The step at the roofline: MODEL_FLOPS at peak for train and
        prefill; the minimum HBM traffic at full bandwidth for decode."""
        if self.kind == "decode":
            return self.min_bytes / (self.chips * HBM_BW)
        return self.model_flops / (self.chips * PEAK_FLOPS)

    @property
    def roofline_fraction(self) -> float:
        """Ideal step over dominant-term time (1.0 = at the roofline)."""
        return self.ideal_s / self.step_s if self.step_s else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "chips": self.chips,
            "flops": self.flops, "bytes": self.bytes_accessed,
            "wire_bytes": self.wire_bytes, "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "collective_bf16_s": self.collective_bf16_s,
            "bottleneck": self.bottleneck,
            "step_s": self.step_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def assemble(arch: str, shape, chips: int,
             full: CellCost, layer: Optional[CellCost],
             n_bodies: int, model_flops: float,
             min_bytes: float = 0.0, kind: str = "train") -> Roofline:
    """total = full + (n_bodies-1) × layer (``layer=None``: full alone)."""
    extra = max(n_bodies - 1, 0)
    if layer is None:
        extra = 0
        layer = CellCost(0, 0, 0, {})
    return Roofline(
        arch=arch, shape=shape, chips=chips,
        flops=full.flops + extra * layer.flops,
        bytes_accessed=full.bytes_accessed + extra * layer.bytes_accessed,
        wire_bytes=full.wire_bytes + extra * layer.wire_bytes,
        wire_bytes_bf16=(full.wire_bytes_bf16
                         + extra * layer.wire_bytes_bf16),
        model_flops=model_flops, min_bytes=min_bytes, kind=kind,
    )


def model_flops_estimate(cfg, shape) -> float:
    """6·N_active·D for training; 2·N_active·D for inference (per step)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def min_bytes_estimate(cfg, shape) -> float:
    """Analytic minimum GLOBAL HBM traffic for one decode step: every active
    parameter read once (bf16) + the KV/state cache read once."""
    pbytes = 2.0 * cfg.active_param_count()
    cache = 0.0
    B, S = shape.global_batch, shape.seq_len
    pat = cfg.superlayer_pattern
    n_attn_layers = 0
    for kind in pat:
        if kind.startswith("attn") or kind == "shared_attn":
            n_attn_layers += 1
    n_attn = cfg.num_superlayers * n_attn_layers
    if cfg.num_heads:
        w = cfg.window_size or S
        # local layers read only the window
        if cfg.attn_kind == "local_global" and cfg.local_per_global:
            n_local = cfg.num_superlayers * cfg.local_per_global
            n_global = cfg.num_superlayers
            cache += n_local * B * min(w, S) * cfg.kv_dim * 2 * 2
            cache += n_global * B * S * cfg.kv_dim * 2 * 2
        else:
            cache += n_attn * B * S * cfg.kv_dim * 2 * 2
    if cfg.ssm_kind == "mamba2":
        n_ssm = cfg.num_layers
        cache += (n_ssm * B * cfg.ssm_nheads * cfg.ssm_head_dim
                  * cfg.ssm_state * 4)
    if cfg.ssm_kind == "rwkv6":
        nh = cfg.d_model // cfg.ssm_head_dim
        cache += cfg.num_layers * B * nh * cfg.ssm_head_dim ** 2 * 4
    return pbytes + cache


def report(jsonl_path: str) -> str:
    """Markdown roofline table from the dry-run's JSONL records."""
    cells = {}
    mems = {}
    for line in open(jsonl_path):
        try:
            r = json.loads(line)
        except json.JSONDecodeError:
            continue
        if not r.get("ok"):
            continue
        key = (r["arch"], r["shape"])
        if r["mesh"] == "single" and "roofline" in r:
            cells[key] = r
        mems[(r["arch"], r["shape"], r["mesh"])] = \
            r["memory"]["per_device_total"] / 2 ** 30

    out = ["| arch | shape | compute s | memory s | collective s | "
           "bottleneck | roofline frac | useful FLOPs | GiB/dev (1 pod) | "
           "GiB/dev (2 pod) |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape), r in sorted(cells.items()):
        ro = r["roofline"]
        m1 = mems.get((arch, shape, "single"), float("nan"))
        m2 = mems.get((arch, shape, "multi"), float("nan"))
        out.append(
            f"| {arch} | {shape} | {ro['compute_s']:.4f} | "
            f"{ro['memory_s']:.4f} | {ro['collective_s']:.4f} | "
            f"{ro['bottleneck']} | {ro['roofline_fraction']:.3f} | "
            f"{ro['useful_flops_ratio']:.3f} | {m1:.1f} | {m2:.1f} |")
    return "\n".join(out)


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default="build/dryrun_torch.jsonl")
    args = ap.parse_args()
    print(report(args.artifacts))


if __name__ == "__main__":
    main()
