"""The port's ServingRuntime against the JAX package's.

Two partitions (dense and sparse24) of reduced llama3-8b in f32, the same
spec for both packages (the port reads the JAX backend names), the same
seeded tenants and requests. Tokens, per-request step stamps, the fused
report's step-domain fields and the migration records must be equal, with
lane overlap on and off, through a forced mid-request ``migrate`` and
through a ``load_aware`` migration. Overlap groups come from measured wall
times, so they are not compared.
"""
import json

import pytest

from repro.runtime import partition as jpt
from repro.runtime import server as jsv
from repro_torch.runtime import partition as tpt
from repro_torch.runtime import server as tsv
from torch_runtime_parity import (
    CFG, JRT, MAX_LEN, TRT, outs, params, requests, steps, tenant_rows)

DENSE, SPARSE = "bf16:dense:jnp", "bf16:sparse24:jnp"


def _spec(mod, policies, **kw):
    return mod.ServingSpec(
        partitions=tuple(mod.PartitionSpec(policy=p) for p in policies),
        placement=kw.pop("placement", "spread"), batch_slots=2,
        max_len=MAX_LEN, **kw)


def _both(policies, **kw):
    jp, tp = params()
    jrt = jsv.ServingRuntime(jp, CFG, _spec(jsv, policies, **kw), rt=JRT)
    trt = tsv.ServingRuntime(tp, CFG, _spec(tsv, policies, **kw), rt=TRT,
                             device="cpu")
    return jrt, trt


def _migrations(rt):
    return [m.to_dict() for m in rt.migrations]


def test_spec_json_equals_the_reference_text():
    kw = dict(placement="packed", batch_slots=4, max_len=96, seed=3,
              policy=DENSE, overlap=False, metrics=True,
              controller={"interval": 4})
    texts = []
    for mod in (jsv, tsv):
        spec = mod.ServingSpec(
            partitions=(mod.PartitionSpec(policy=SPARSE, quota="adaptive"),
                        mod.PartitionSpec(admission="fifo", batch_slots=8,
                                          paged=True, pages=12)),
            migration=mod.MigrationSpec(enabled=True, interval=5,
                                        threshold=3.0, cooldown=7,
                                        max_migrations=2),
            tenants=(mod.TenantSpec(id="a", weight=2.0, partition=1,
                                    slo="latency:12"),
                     mod.TenantSpec(id="b", slo="batch:0.9")), **kw)
        texts.append(spec.to_json())
        assert mod.ServingSpec.from_json(texts[-1]).to_json() \
            == texts[-1]
    assert texts[0] == texts[1]
    assert json.loads(texts[1])["partitions"][1]["pages"] == 12


@pytest.mark.parametrize("backend", ["jnp", "hopper"])
@pytest.mark.parametrize("overlap", [True, False])
def test_two_partitions_dense_and_sparse24_match_jax(overlap, backend):
    """The port's ``torch`` backend (JAX name ``jnp``) and its ``hopper``
    backend (the kernels' plain twins on the CPU) against JAX's ``jnp``."""
    jp, tp = params()
    jrt = jsv.ServingRuntime(jp, CFG, _spec(jsv, [DENSE, SPARSE],
                                            overlap=overlap), rt=JRT)
    tpols = [p.replace("jnp", backend) for p in (DENSE, SPARSE)]
    trt = tsv.ServingRuntime(tp, CFG, _spec(tsv, tpols, overlap=overlap),
                             rt=TRT, device="cpu")
    got = []
    for rt, reqs in ((jrt, requests(0, n=3)[0] + requests(1, n=3)[0]),
                     (trt, requests(0, n=3)[1] + requests(1, n=3)[1])):
        rt.add_tenant("t0", slo="latency:12")
        rt.add_tenant("t1")
        for j, r in enumerate(reqs):
            rt.submit(f"t{j % 2}", r)
        rt.drain()
        assert all(r.done for r in reqs)
        rep = rt.report()
        got.append((outs(reqs), steps(reqs), rt.step_count,
                    tenant_rows(rep), rep.tenant_partition, rep.policies))
    assert got[0][:5] == got[1][:5]
    # the port names the JAX backend by its own name
    port = "torch" if backend == "jnp" else backend
    assert got[1][5] == [f"bf16:dense:{port}", f"bf16:sparse24:{port}"]
    if overlap:
        lanes = {e.lane for e in trt.merged_tracer().events("decode")
                 if e.overlap_group >= 0}
        assert lanes <= {"lane0", "lane1"}


@pytest.mark.parametrize("overlap", [True, False])
def test_forced_migration_mid_request_matches_jax(overlap):
    jrt, trt = _both([DENSE, DENSE], overlap=overlap)
    got = []
    for rt, reqs in ((jrt, requests(0, n=2, max_new=10)[0]),
                     (trt, requests(0, n=2, max_new=10)[1])):
        rt.add_tenant("mover", partition=0)
        for r in reqs:
            rt.submit("mover", r)
        for _ in range(3):
            rt.step()
        assert rt.sessions[0].n_active == 2
        rt.migrate("mover", 1)
        rt.drain()
        phases = [e.meta["phase"]
                  for e in rt.merged_tracer().events("migrate")]
        got.append((outs(reqs), steps(reqs), _migrations(rt),
                    tenant_rows(rt.report()), sorted(phases)))
    assert got[0] == got[1]
    assert got[1][4].count("handoff") == 4


def test_load_aware_migration_matches_jax():
    mig = dict(enabled=True, interval=4, threshold=2.0, cooldown=8)
    jp, tp = params()
    rts = [jsv.ServingRuntime(jp, CFG, _spec(jsv, [DENSE, DENSE],
                                             migration=jsv.MigrationSpec(
                                                 **mig),
                                             placement="load_aware"),
                              rt=JRT),
           tsv.ServingRuntime(tp, CFG, _spec(tsv, [DENSE, DENSE],
                                             migration=tsv.MigrationSpec(
                                                 **mig),
                                             placement="load_aware"),
                              rt=TRT, device="cpu")]
    got = []
    for k, rt in enumerate(rts):
        rt.add_tenant("hog", partition=0)
        rt.add_tenant("victim", partition=0)
        hog = requests(0, n=6, max_new=8)[k]
        vic = requests(1, n=2, max_new=6)[k]
        for r in hog:
            rt.submit("hog", r)
        for r in vic:
            rt.submit("victim", r)
        rt.drain()
        got.append((outs(hog + vic), steps(hog + vic), _migrations(rt),
                    tenant_rows(rt.report()), dict(rt.tenant_partition)))
    assert got[0] == got[1]
    assert got[1][2] and got[1][2][0]["reason"] == "load_aware"


def test_partitions_on_one_device_are_logical_and_share_params():
    _, tp = params()
    rt = tsv.ServingRuntime(tp, CFG, _spec(tsv, [DENSE, DENSE]), rt=TRT,
                            device="cpu")
    assert all(p.logical for p in rt.partitions)
    a, b = (s.params["layers"][0]["attn"]["w_q"] for s in rt.sessions)
    assert a.data_ptr() == b.data_ptr()
    assert [ln.stream for ln in rt.lanes] == [None, None]
    assert tsv.make_partitions(2, ["cpu", "cpu"])[1].devices[0].type == "cpu"


def test_deprecated_partition_shims_match_jax():
    jp, tp = params()
    got = []
    for k, (pt, p, rt, kw) in enumerate(((jpt, jp, JRT, {}),
                                         (tpt, tp, TRT, {"device": "cpu"}))):
        with pytest.warns(DeprecationWarning):
            srv = pt.PartitionedServer(p, CFG, n_partitions=2,
                                       batch_slots=2, max_len=MAX_LEN,
                                       rt=rt, **kw)
        srv.add_tenant("a")
        srv.add_tenant("b")
        reqs = requests(3, n=4, max_new=4)[k]
        for j, r in enumerate(reqs):
            srv.submit("ab"[j % 2], r)
        srv.run()
        wl = {"a": requests(4, n=2)[k], "b": requests(5, n=3)[k]}
        with pytest.warns(DeprecationWarning):
            rep = pt.run_partitioned(p, CFG, wl, n_partitions=2,
                                     batch_slots=2, max_len=MAX_LEN, rt=rt,
                                     **kw)
        got.append((outs(reqs), steps(reqs), tenant_rows(srv.report()),
                    outs(wl["a"] + wl["b"]), tenant_rows(rep)))
    assert got[0] == got[1]


@pytest.mark.parametrize("draft", ["bf16:dense:jnp", "fp8:dense:jnp"])
def test_speculative_partition_matches_jax(draft):
    """A partition that drafts k = 3 under ``draft`` (the port's draft
    runs on a lane of its own) beside a plain one: the tokens, step
    stamps and the per-tenant speculative accounting equal JAX's."""
    jp, tp = params()
    got = []
    for k, (sv, p, rt, kw) in enumerate(((jsv, jp, JRT, {}),
                                         (tsv, tp, TRT, {"device": "cpu"}))):
        spec = sv.ServingSpec(
            partitions=(sv.PartitionSpec(policy=DENSE, speculative={
                "k": 3, "draft_policy": draft}),
                sv.PartitionSpec(policy=DENSE)),
            placement="spread", batch_slots=2, max_len=MAX_LEN)
        runtime = sv.ServingRuntime(p, CFG, spec, rt=rt, **kw)
        runtime.add_tenant("s")
        runtime.add_tenant("p")
        reqs = requests(6, n=4, max_new=7)[k]
        for j, r in enumerate(reqs):
            runtime.submit("sp"[j % 2], r)
        runtime.drain()
        got.append((outs(reqs), steps(reqs), tenant_rows(runtime.report()),
                    runtime.step_count))
    assert got[0] == got[1]
    assert got[1][2][0]["spec_steps"] > 0
