"""DEPRECATED facade — the original partitioned serving entry point.

The control plane moved to :mod:`repro_torch.runtime.server`: construct a
:class:`~repro_torch.runtime.server.ServingRuntime` from a declarative
:class:`~repro_torch.runtime.server.ServingSpec` instead (per-partition
execution policies, admission/quota, placement, live tenant migration —
see docs/serving_api.md for the migration guide). This module keeps the
old names importable for one release:

* :class:`DevicePartition` / :func:`make_partitions` /
  :class:`PartitionedReport` — re-exported from ``runtime.server``
  (unchanged semantics).
* :class:`PartitionedServer` — a thin shim over ``ServingRuntime`` with
  the legacy constructor signature and the ``run()`` verb (now
  ``drain()``). Emits a :class:`DeprecationWarning`.
* :func:`run_partitioned` — delegates to
  :func:`~repro_torch.runtime.server.run_serving`.

Behavioral note: the runtime steps partitions in LOCKSTEP (every
partition ticks every round — the documented model the old facade only
approximated), which keeps request step accounting in one global domain
so fairness/turnaround stay exact across live migrations.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence, Union

from repro_torch.runtime.server import (           # noqa: F401 — re-exports
    PLACEMENTS, DevicePartition, MigrationRecord, PartitionedReport,
    PartitionSpec, ServingRuntime, ServingSpec, make_partitions,
    run_serving)
from repro_torch.runtime.scheduler import QuotaPolicy
from repro_torch.runtime.serve_loop import Request


def _warn(old: str) -> None:
    warnings.warn(
        f"{old} is deprecated: build a ServingRuntime from a ServingSpec "
        "(repro_torch.runtime.server); see docs/serving_api.md for the "
        "migration guide",
        DeprecationWarning, stacklevel=3)


class PartitionedServer:
    """Deprecated shim: the original facade over the new control plane.

    All attributes (``schedulers``/``sessions``/``tracers``/
    ``tenant_partition``/``report``/``merged_tracer``/…) delegate to the
    wrapped :class:`~repro_torch.runtime.server.ServingRuntime`; ``run`` maps to
    ``drain``."""

    def __init__(self, params, cfg, *, n_partitions: int = 1,
                 batch_slots: int = 4, max_len: int = 128, rt=None,
                 placement: str = "spread",
                 admission: str = "fair_quantum",
                 quota: Union[None, str, QuotaPolicy, Sequence] = None,
                 temperature: float = 0.0, seed: int = 0, policy=None,
                 partitions: Optional[Sequence[DevicePartition]] = None,
                 tracer_capacity: int = 4096, session_kw=None, device=None):
        _warn("PartitionedServer")
        n = n_partitions if partitions is None else len(partitions)
        spec = ServingSpec(
            partitions=tuple(PartitionSpec(admission=admission)
                             for _ in range(max(1, n))),
            placement=placement, batch_slots=batch_slots, max_len=max_len,
            temperature=temperature, seed=seed)
        self._runtime = ServingRuntime(
            params, cfg, spec, rt=rt, policy=policy, quota=quota,
            partitions=partitions, tracer_capacity=tracer_capacity,
            session_kw=session_kw, device=device)

    @property
    def runtime(self) -> ServingRuntime:
        return self._runtime

    def run(self, max_steps: int = 100_000):
        return self._runtime.drain(max_steps=max_steps)

    def __getattr__(self, name):
        return getattr(self._runtime, name)


def run_partitioned(params, cfg, workloads: Dict[str, Sequence[Request]],
                    *, n_partitions: int = 1,
                    placement: str = "spread",
                    admission: str = "fair_quantum",
                    quota: Union[None, str] = None,
                    weights: Optional[Dict[str, float]] = None,
                    max_steps: int = 100_000, batch_slots: int = 4,
                    max_len: int = 128, rt=None, **server_kw
                    ) -> PartitionedReport:
    """Deprecated one-shot helper — use
    :func:`~repro_torch.runtime.server.run_serving` with a ServingSpec."""
    _warn("run_partitioned")
    spec = ServingSpec(
        partitions=tuple(PartitionSpec(admission=admission)
                         for _ in range(max(1, n_partitions))),
        placement=placement, batch_slots=batch_slots, max_len=max_len,
        seed=server_kw.pop("seed", 0),
        temperature=server_kw.pop("temperature", 0.0))
    return run_serving(params, cfg, spec, workloads, weights=weights,
                       max_steps=max_steps, rt=rt, quota=quota, **server_kw)
