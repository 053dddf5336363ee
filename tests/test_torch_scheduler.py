"""The port's StreamScheduler against the JAX package's.

One session of reduced llama3-8b in f32 (2 slots) serves three tenants of
different request costs under each admission policy; the tokens, every
request's submit/admit/finish steps, the admission order and the report's
step-domain fields must equal JAX's.
"""
import pytest

from repro.core import execution as jex
from repro.runtime import scheduler as jsc
from repro.runtime import serve_loop as jsl
from repro.runtime import telemetry as jtel
from repro_torch.core import execution as tex
from repro_torch.runtime import scheduler as tsc
from repro_torch.runtime import serve_loop as tsl
from repro_torch.runtime import telemetry as ttel
from torch_runtime_parity import (
    CFG, JRT, MAX_LEN, TRT, outs, params, requests, steps, tenant_rows)

REPORT_FIELDS = ("admission", "quota", "n_tenants", "steps", "tokens_out",
                 "fairness", "fairness_min_max", "cv", "overlap_efficiency")


def _workloads(k):
    return {"a": requests(0, n=3, max_new=4, length=5)[k],
            "b": requests(1, n=2, max_new=7, length=9)[k],
            "c": requests(2, n=2, max_new=3, length=4)[k]}


def _run(k, admission, quota=None, policy="bf16:dense:jnp"):
    jp, tp = params()
    if k == 0:
        sess = jsl.ServeSession(jp, CFG, batch_slots=2, max_len=MAX_LEN,
                                rt=JRT, policy=jex.parse_policy(policy))
        mod, tel = jsc, jtel
    else:
        sess = tsl.ServeSession(tp, CFG, batch_slots=2, max_len=MAX_LEN,
                                rt=TRT, policy=tex.parse_policy(policy),
                                device="cpu")
        mod, tel = tsc, ttel
    tracer = tel.Tracer()
    sched = mod.StreamScheduler(sess, admission=admission, tracer=tracer,
                                quota=quota)
    wl = _workloads(k)
    for tid in wl:
        sched.add_tenant(tid, weight=2.0 if tid == "b" else 1.0,
                         slo="latency:10" if tid == "a" else None)
    for tid, reqs in wl.items():
        for r in reqs:
            sched.submit(tid, r)
    sched.run()
    reqs = [r for rs in wl.values() for r in rs]
    rep = sched.report()
    return (outs(reqs), steps(reqs), sched.admitted_order,
            {f: getattr(rep, f) for f in REPORT_FIELDS}, tenant_rows(rep),
            tracer.counts())


@pytest.mark.parametrize("admission", ["fifo", "round_robin",
                                       "fair_quantum"])
def test_scheduler_matches_jax(admission):
    want, got = _run(0, admission), _run(1, admission)
    assert got == want
    assert got[3]["steps"] > 0 and len(got[0]) == 7


def test_adaptive_quota_matches_jax():
    assert _run(1, "fair_quantum", quota="adaptive") == \
        _run(0, "fair_quantum", quota="adaptive")


@pytest.mark.parametrize("admission", ["fifo", "round_robin",
                                       "fair_quantum"])
def test_run_tenants_matches_jax(admission):
    jp, tp = params()
    reports = []
    for k, (sl, sc, ex, p, rt, kw) in enumerate((
            (jsl, jsc, jex, jp, JRT, {}),
            (tsl, tsc, tex, tp, TRT, {"device": "cpu"}))):
        sess = sl.ServeSession(p, CFG, batch_slots=2, max_len=MAX_LEN,
                               rt=rt, policy=ex.parse_policy(
                                   "bf16:sparse24:jnp"), **kw)
        wl = _workloads(k)
        rep = sc.run_tenants(sess, wl, admission=admission,
                             weights={"b": 2.0})
        reqs = [r for rs in wl.values() for r in rs]
        reports.append((outs(reqs), steps(reqs),
                        {f: getattr(rep, f) for f in REPORT_FIELDS},
                        tenant_rows(rep)))
    assert reports[0] == reports[1]


def test_slo_parsing_and_attainment_match_jax():
    for spec in ("latency:8", "latency:0.05@wall_s", "throughput:2.5",
                 "batch", "batch:0.9"):
        j, t = jsc.SLO.parse(spec), tsc.SLO.parse(spec)
        assert (t.kind, t.target, t.metric, t.spec()) == \
            (j.kind, j.target, j.metric, j.spec())
        kw = dict(samples=[3.0, 9.0, 12.0], tokens_out=40, steps=20,
                  completed=3, submitted=4)
        assert t.attainment(**kw) == j.attainment(**kw)
