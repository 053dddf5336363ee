"""Measurement records.

Twin of the ``Record`` dataclass of ``repro/core/characterization.py``: one
named measurement (microseconds per call) with its derived fields, in the
form the block-shape evidence paths read (``pagedsweep/...`` names from
:func:`repro_torch.kernels.paged_attention.sweep_paged_tilings`). The
microbenchmarks of the reference module are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass
class Record:
    name: str
    us_per_call: float
    derived: Dict[str, Any]

    def csv(self) -> str:
        extra = ";".join(f"{k}={v}" for k, v in self.derived.items())
        return f"{self.name},{self.us_per_call:.2f},{extra}"
