"""Mixed-precision routing policies (paper §8.3 + §9.2).

Twin of ``repro/core/precision.py``, a plain copy. The paper's
mixed-precision case study shows FP8/FP16/FP32 stages have different
occupancy/batching sensitivities and should be scheduled precision-aware.
This module encodes that as a per-op-class policy object the framework
consults when building models and serving plans — the same role
Transformer-Engine recipes play, but explicit and testable. As in the
reference, nothing outside the tests calls it yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# Op classes, ordered roughly by numerical sensitivity (paper §9.2: keep
# precision-sensitive ops high while bulk GEMMs drop to FP8).
OP_CLASSES = (
    "router",        # MoE gate logits — f32 always (paper: precision-aware)
    "logits",        # LM head — f32 accumulation, high-precision softmax
    "norm",          # rms/layer norms — f32 statistics
    "attention_softmax",
    "qkv_proj",
    "attn_out_proj",
    "mlp",
    "expert_mlp",
    "ssm_recurrence",  # state accumulation — never FP8 (DESIGN.md §4)
)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Maps op classes to compute dtypes + quantization choices."""
    name: str
    rules: Dict[str, str]        # op class -> "f32" | "bf16" | "fp8"
    grad_dtype: str = "e5m2"     # fp8 gradient format (range-wide)
    fwd_dtype: str = "e4m3"      # fp8 forward format (precision-narrow)

    def dtype_for(self, op_class: str) -> str:
        if op_class not in self.rules:
            raise KeyError(f"unknown op class {op_class!r}; "
                           f"known: {OP_CLASSES}")
        return self.rules[op_class]

    def uses_fp8(self) -> bool:
        return any(v == "fp8" for v in self.rules.values())


def _mk(name, **overrides) -> PrecisionPolicy:
    base = {
        "router": "f32",
        "logits": "f32",
        "norm": "f32",
        "attention_softmax": "f32",
        "qkv_proj": "bf16",
        "attn_out_proj": "bf16",
        "mlp": "bf16",
        "expert_mlp": "bf16",
        "ssm_recurrence": "f32",
    }
    base.update(overrides)
    return PrecisionPolicy(name=name, rules=base)


# The three deployment presets the paper's case studies correspond to:
BF16_BASELINE = _mk("bf16_baseline")
# paper-faithful FP8 recipe: all bulk GEMMs in FP8, sensitive ops high
FP8_TRAINING = _mk("fp8_training",
                   qkv_proj="fp8", attn_out_proj="fp8", mlp="fp8",
                   expert_mlp="fp8")
# serving: weights FP8 (+2:4-packable); softmax/logits still f32
FP8_SERVING = _mk("fp8_serving",
                  qkv_proj="fp8", attn_out_proj="fp8", mlp="fp8",
                  expert_mlp="fp8")

POLICIES = {p.name: p for p in (BF16_BASELINE, FP8_TRAINING, FP8_SERVING)}


def policy_for(precision: str, serving: bool = False) -> PrecisionPolicy:
    """Resolve an ArchConfig.precision string to a policy."""
    if precision == "fp8":
        return FP8_SERVING if serving else FP8_TRAINING
    return BF16_BASELINE


def validate(policy: PrecisionPolicy) -> None:
    """Invariants the paper's findings impose."""
    for op in ("router", "norm", "ssm_recurrence"):
        if policy.dtype_for(op) == "fp8":
            raise ValueError(
                f"{policy.name}: op class {op!r} must not run in FP8 "
                "(paper §9.2 / DESIGN.md §4 numerical-sensitivity rule)")
    if policy.grad_dtype not in ("e5m2", "bf16"):
        raise ValueError("gradients need range-wide formats (E5M2/bf16)")
