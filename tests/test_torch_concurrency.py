"""The port's concurrency layer against the JAX package's.

The stream metrics on the same seeded times, the occupancy advisor over a
grid of profiles, the core count with and without ``REPRO_N_CORES``, and
lanes and ``characterize_streams`` on the CPU (a CPU lane has no stream and
runs its thunk at once). The card's lanes are in test_torch_cuda.py.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.core import concurrency as jcc
from repro_torch.core import concurrency as tcc


@pytest.mark.parametrize("seed", range(6))
def test_stream_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    times = list(rng.exponential(1.0, size=int(rng.integers(0, 9))))
    for name in ("fairness", "fairness_raw", "fairness_min_max", "cv"):
        assert getattr(tcc, name)(times) == getattr(jcc, name)(times), name
    assert tcc.latency_percentiles(times, (50, 90, 99)) == \
        jcc.latency_percentiles(times, (50, 90, 99))
    serial = float(sum(times))
    for wall in (serial, serial / 2, serial / 8, 0.0):
        for n in (1, 2, 4, 8):
            assert tcc.overlap_efficiency(serial, wall, n) == \
                jcc.overlap_efficiency(serial, wall, n)


def test_occupancy_advisor_matches_jax():
    grid = itertools.product(("fp8", "bf16", "fp32"),
                             (1, 16, 64, 112, 132, 255, 256, 448, 1024),
                             (False, True), (1, 2, 4, 5, 8), (132, 256))
    for prec, tiles, lat, tenants, cores in grid:
        prof = dict(precision=prec, grid_tiles=tiles,
                    latency_sensitive=lat, concurrent_tenants=tenants)
        want = jcc.OccupancyAdvisor(cores).advise(jcc.WorkloadProfile(**prof))
        got = tcc.OccupancyAdvisor(cores).advise(tcc.WorkloadProfile(**prof))
        assert (got.use_sparsity, got.max_streams, got.suggested_precision,
                got.batch_multiplier, len(got.rationale)) == \
            (want.use_sparsity, want.max_streams, want.suggested_precision,
             want.batch_multiplier, len(want.rationale)), prof
    assert (tcc.OccupancyAdvisor.FP8_TILE_THRESHOLD,
            tcc.OccupancyAdvisor.BF16_TILE_THRESHOLD) == \
        (jcc.OccupancyAdvisor.FP8_TILE_THRESHOLD,
         jcc.OccupancyAdvisor.BF16_TILE_THRESHOLD)


def test_detect_core_count(monkeypatch):
    monkeypatch.delenv("REPRO_N_CORES", raising=False)
    assert tcc.DEFAULT_N_CORES == jcc.DEFAULT_N_CORES == 256
    if torch.cuda.is_available():
        want = sum(torch.cuda.get_device_properties(i).multi_processor_count
                   for i in range(torch.cuda.device_count()))
    else:
        want = jcc.detect_core_count()      # the CPU keeps the table value
        assert want == 256
    assert tcc.detect_core_count() == want
    monkeypatch.setenv("REPRO_N_CORES", "132")
    assert tcc.detect_core_count() == jcc.detect_core_count() == 132
    assert tcc.OccupancyAdvisor().n_cores == 132
    for bad in ("many", "-4"):
        monkeypatch.setenv("REPRO_N_CORES", bad)
        with pytest.warns(RuntimeWarning):
            got = tcc.detect_core_count(default=7)
        assert got == (want if torch.cuda.is_available() else 7)


def test_cpu_lane_runs_thunks_in_order_and_joins():
    tr_events = []

    class Rec:
        def record(self, kind, **kw):
            tr_events.append((kind, kw["lane"], kw["meta"]["label"]))

    lane = tcc.ExecutionLane("l0", index=2, tracer=Rec(), device="cpu")
    assert lane.stream is None and lane.device.type == "cpu"
    order = []
    hs = [lane.dispatch(lambda i=i: order.append(i) or i * i,
                        label=f"t{i}", overlap_group=i) for i in range(3)]
    assert order == [0, 1, 2]              # ran at dispatch
    assert not any(h.done for h in hs)
    assert lane.join_all() == [0, 1, 4]
    assert all(h.done and h.dispatch_to_ready_s >= 0 for h in hs)
    assert [h.overlap_group for h in hs] == [0, 1, 2]
    assert tr_events == [("dispatch", "l0", f"t{i}") for i in range(3)]
    # a joined handle is dropped at the next dispatch: a long-serving lane
    # keeps no finished step's tensors alive
    h = lane.dispatch(lambda: 9)
    assert lane.handles == [h]
    lane.reset()
    assert lane.handles == []


def test_lane_needs_a_device_on_a_cpu_only_machine():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: lanes default to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcc.ExecutionLane("l0")


@pytest.mark.parametrize("mode", ["async", "serial"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_characterize_streams_on_the_cpu_reports_the_reference_keys(mode, n):
    calls = []

    def make(i):
        def thunk():
            calls.append(i)
            return torch.full((4, 4), float(i)) @ torch.ones(4, 4)
        return thunk

    events = []

    class Rec:
        def record_stream(self, i, s, **kw):
            events.append(("stream", i))

        def record(self, kind, **kw):
            events.append((kind, kw["meta"]["n_streams"]))

    rep = tcc.characterize_streams(make, n, mode=mode, tracer=Rec(),
                                   device="cpu")
    # warm-up (serial, and async on the lanes it times), serial, timed
    assert calls == list(range(n)) * (4 if mode == "async" else 3)
    assert rep.n_streams == n and rep.mode == mode
    assert len(rep.per_stream_s) == n and rep.wall_s > 0
    assert 0.0 <= rep.fairness <= 1.0 and rep.overlap_efficiency <= 1.0
    jrep = jcc.StreamReport(**{**rep.__dict__})
    assert sorted(rep.to_dict()) == sorted(jrep.to_dict())
    assert events == [("stream", i) for i in range(n)] + \
        [("stream_report", n)]
    rec = rep.to_record(f"streams/{n}", precision="bf16")
    assert rec.us_per_call == rep.wall_s * 1e6
    assert rec.derived["precision"] == "bf16"
    assert rec.derived["n_streams"] == n


def test_run_spatial_and_serial_on_the_cpu():
    fns = [(lambda a: a + 1, (torch.zeros(2),)) for _ in range(3)]
    times = tcc.run_spatial(fns, ["cpu"])
    assert len(times) == 3 and times == sorted(times)
    assert len(tcc.run_serial([lambda: 1, lambda: 2], device="cpu")) == 2
    assert len(tcc.run_async_dispatch([lambda: 1] * 3, device="cpu")) == 3
