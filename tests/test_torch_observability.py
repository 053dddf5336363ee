"""The port's observability plane against the JAX package's.

One fixed event stream (explicit timestamps, every kind the runtime
emits, two partitions, a live migration and an overlap pair) is ingested
by both packages' tracers: the tracer summary and views, the metrics
registry's Prometheus text and JSON, and the Chrome trace with its
``validate`` / ``overlapping_groups`` / ``migration_flow_pairs`` results
must be equal. The SLO controller must take the reference's actions, at
the reference's steps, on one contended trace.
"""
import json

from repro.runtime import controller as jct
from repro.runtime import metrics as jme
from repro.runtime import server as jsv
from repro.runtime import telemetry as jtel
from repro.runtime import traceview as jtv
from repro.runtime import workload as jwl
from repro_torch.runtime import controller as tct
from repro_torch.runtime import metrics as tme
from repro_torch.runtime import server as tsv
from repro_torch.runtime import telemetry as ttel
from repro_torch.runtime import traceview as ttv
from repro_torch.runtime import workload as twl
from torch_runtime_parity import CFG, JRT, TRT, params

T0 = 1000.0


def _events():
    """(partition, kind, fields) in order; ``t`` is fixed."""
    evs = []
    t = T0
    for p in (0, 1):
        evs.append((p, "register", dict(tenant=f"t{p}", step=0,
                                        meta={"weight": 1.0, "slo": ""})))
        evs.append((p, "route", dict(tenant=f"t{p}",
                                     meta={"weight": 1.0,
                                           "placement": "spread"})))
    for step in range(6):
        for p in (0, 1):
            t += 0.004
            if step % 3 == 0:
                evs.append((p, "admit", dict(tenant=f"t{p}", step=step,
                                             meta={"uid": step * 10 + p,
                                                   "cost": 12})))
                evs.append((p, "prefill", dict(
                    m=5, k=128, n=512, precision="bf16", wall_s=0.003,
                    tenant=f"t{p}", meta={"uid": step * 10 + p, "slot": 0},
                    t=t)))
            evs.append((p, "decode", dict(
                m=2, k=128, n=512, precision="bf16",
                policy="bf16:dense:jnp" if p == 0 else "bf16:sparse24:jnp",
                wall_s=0.002 + 0.001 * p + 0.0001 * step,
                lane=f"lane{p}", overlap_group=step if step >= 2 else -1,
                meta={"n_active": 2}, t=t + 0.002)))
            if step >= 2:
                evs.append((p, "overlap", dict(
                    lane=f"lane{p}", overlap_group=step, step=step,
                    meta={"group": [0, 1]})))
            evs.append((p, "paging", dict(
                tenant=f"t{p}", meta={"phase": "admit", "slot": 0,
                                      "pages_in_use": 3 + step,
                                      "utilization": 0.5})))
            if step % 2:
                evs.append((p, "request", dict(
                    tenant=f"t{p}", wall_s=0.01 * (step + p), step=step,
                    meta={"tokens": 6, "turnaround_steps": step + 1,
                          "uid": step * 10 + p})))
        evs.append((0, "spec", dict(tenant="t0", meta={
            "k": 3, "drafted": 2, "accepted": step % 3, "committed": 1})))
    for phase in ("start", "handoff", "done"):
        for p in (0, 1):
            evs.append((p, "migrate", dict(
                tenant="t0", step=6,
                meta={"src": 0, "dst": 1, "phase": phase, "uid": 3,
                      "handoff_bytes": 4096})))
    evs.append((0, "resolve", dict(m=4, k=128, n=512, policy="bf16:dense",
                                   precision="bf16", backend="jnp",
                                   meta={"fill": 0.02})))
    evs.append((1, "matmul", dict(m=4, k=128, n=512, precision="bf16",
                                  backend="jnp", meta={"op": "dense"})))
    evs.append((0, "stream", dict(stream=1, wall_s=0.004,
                                  meta={"mode": "async", "n_streams": 2})))
    return evs


def _tracers(tel, metrics=None):
    trs = [tel.Tracer(capacity=32, partition=p) for p in (0, 1)]
    sink = metrics.MetricsSink(metrics.MetricsRegistry()).attach(*trs) \
        if metrics is not None else None
    for i, (p, kind, fields) in enumerate(_events()):
        fields = dict(fields)
        t = fields.pop("t", T0 + 0.001 * i)
        fields.setdefault("partition", p)
        trs[p]._ingest(tel.Event(kind=kind, t=t, **fields))
    return trs, sink


def test_tracer_views_match_jax():
    (j0, j1), _ = _tracers(jtel)
    (t0, t1), _ = _tracers(ttel)
    jm, tm = jtel.Tracer.merge(j0, j1), ttel.Tracer.merge(t0, t1)
    for j, t in ((j0, t0), (j1, t1), (jm, tm)):
        assert t.summary(n_cores=256) == j.summary(n_cores=256)
        assert t.counts(include_dropped=True) == \
            j.counts(include_dropped=True)
        assert t.dropped() == j.dropped()
        assert t.shape_latency_ema() == j.shape_latency_ema()
        assert t.occupancy_histogram(256) == j.occupancy_histogram(256)
        assert t.mean_fill(256) == j.mean_fill(256)
        assert t.tenant_percentiles() == j.tenant_percentiles()
        assert t.tenant_latencies("turnaround_steps") == \
            j.tenant_latencies("turnaround_steps")
        assert t.tenant_fairness() == j.tenant_fairness()
        assert t.overlap_summary() == j.overlap_summary()
        assert t.stream_overlap() == j.stream_overlap()
        assert t.mean_wall("decode") == j.mean_wall("decode")
        assert t.to_dicts() == j.to_dicts()
    assert "dropped" in t0.summary(n_cores=256)        # ring of 32 evicted


def test_metrics_text_and_json_match_jax(tmp_path):
    _, jsink = _tracers(jtel, jme)
    _, tsink = _tracers(ttel, tme)
    assert tsink.registry.to_prometheus() == jsink.registry.to_prometheus()
    assert tsink.registry.to_json() == jsink.registry.to_json()
    assert "repro_" in tsink.registry.to_prometheus()
    for ext in ("prom", "json"):
        jp = jsink.registry.save(str(tmp_path / f"j.{ext}"))
        tp = tsink.registry.save(str(tmp_path / f"t.{ext}"))
        assert open(tp).read() == open(jp).read()
    reg = tme.MetricsRegistry()
    h = reg.histogram("lat", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v, tenant="a")
    jreg = jme.MetricsRegistry()
    jh = jreg.histogram("lat", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        jh.observe(v, tenant="a")
    reg.counter("c").inc(2, x="1")
    jreg.counter("c").inc(2, x="1")
    reg.gauge("g").set(3.5)
    jreg.gauge("g").set(3.5)
    assert reg.to_prometheus() == jreg.to_prometheus()


def test_chrome_trace_and_its_checks_match_jax(tmp_path):
    (j0, j1), _ = _tracers(jtel)
    (t0, t1), _ = _tracers(ttel)
    jdoc = jtv.to_chrome_trace(jtel.Tracer.merge(j0, j1))
    tdoc = ttv.to_chrome_trace(ttel.Tracer.merge(t0, t1))
    assert json.dumps(tdoc, sort_keys=True) == json.dumps(jdoc, sort_keys=True)
    assert ttv.validate(tdoc) == jtv.validate(jdoc)
    assert ttv.overlapping_groups(tdoc) == jtv.overlapping_groups(jdoc)
    assert ttv.migration_flow_pairs(tdoc) == \
        jtv.migration_flow_pairs(jdoc) == [(1, 2)]
    path = ttv.export_chrome_trace(ttel.Tracer.merge(t0, t1),
                                   str(tmp_path / "t.json"))
    assert ttv.validate(ttv.load(path)) == jtv.validate(jdoc)
    assert ttv.to_chrome_trace(ttel.Tracer())["traceEvents"] == []


def _contended(wl):
    return wl.generate(wl.WorkloadSpec(
        tenants=3, zipf_s=1.1, arrival="bursty", rate=1.0,
        burst_factor=3.0, burst_len=6, steps=16,
        prompt_len=(4, 8), max_new=(6, 9),
        max_new_overrides=(None, None, (2, 4)),
        slos=("batch", "batch", "latency:8"), seed=7))


def test_slo_controller_actions_match_jax():
    jp, tp = params()
    got = []
    for sv, ct, wl, p, rt, kw in ((jsv, jct, jwl, jp, JRT, {}),
                                  (tsv, tct, twl, tp, TRT,
                                   {"device": "cpu"})):
        spec = sv.ServingSpec(
            partitions=(sv.PartitionSpec(admission="fifo"),),
            batch_slots=2, max_len=64, metrics=True,
            controller=ct.ControllerSpec(interval=2, hold=3))
        runtime = sv.ServingRuntime(p, CFG, spec, rt=rt, **kw)
        done = wl.run_trace(runtime, _contended(wl))
        ctrl = runtime.controller
        rep = runtime.report()
        got.append(([a.to_dict() for a in ctrl.actions], ctrl.counts(),
                     ctrl.checks, wl.token_checksum(done),
                     {t.tenant_id: t.slo_attainment for t in rep.tenants},
                     runtime.merged_tracer().counts()["controller"]))
    assert got[1] == got[0]
    assert got[1][1]["freeze"] >= 1
    assert tct.ControllerSpec.parse("interval=2,hold=3").to_dict() == \
        jct.ControllerSpec.parse("interval=2,hold=3").to_dict()
