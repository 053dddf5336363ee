"""The port's workload plane against the JAX package's.

``generate`` must give byte-equal trace JSON for the same spec (numpy
only), a saved trace must load in either package, and one trace made by
JAX's ``generate`` and replayed through both runtimes must give the same
``token_checksum``, the same per-request step stamps and the same
``top`` dashboard frame.
"""
import pytest

from repro.launch import top as jtop
from repro.runtime import server as jsv
from repro.runtime import workload as jwl
from repro_torch.launch import top as ttop
from repro_torch.runtime import server as tsv
from repro_torch.runtime import workload as twl
from torch_runtime_parity import CFG, JRT, TRT, params, steps

SPECS = [
    dict(tenants=3, arrival="poisson", rate=0.8, steps=12, seed=0,
         prompt_len=(4, 9), max_new=(2, 6)),
    dict(tenants=4, zipf_s=1.3, arrival="bursty", rate=1.2,
         burst_factor=3.0, burst_len=4, steps=20, seed=5,
         prompt_len={"lo": 3, "hi": 6, "long_frac": 0.25, "long_lo": 20,
                     "long_hi": 30},
         max_new=(3, 5), slos=("latency:8", None, "batch", None),
         weights=(2.0, 1.0, 1.0, 1.0)),
    dict(tenants=2, arrival="diurnal", rate=1.5, amplitude=0.8, period=6,
         steps=15, seed=11, max_new_overrides=((1, 2), None)),
]


@pytest.mark.parametrize("kw", SPECS)
def test_generate_is_byte_equal_to_jax(kw, tmp_path):
    jtr = jwl.generate(jwl.WorkloadSpec(**kw))
    ttr = twl.generate(twl.WorkloadSpec(**kw))
    assert ttr.to_json() == jtr.to_json()
    assert ttr.arrivals_per_tenant() == jtr.arrivals_per_tenant()
    path = tmp_path / "trace.json"
    jtr.save(path)
    assert twl.WorkloadTrace.load(path).to_json() == jtr.to_json()
    assert twl.zipf_weights(4, 1.3).tolist() == \
        jwl.zipf_weights(4, 1.3).tolist()


def _replay(sv, wl, top, trace_json, p, rt, overlap, **kw):
    spec = sv.ServingSpec(
        partitions=(sv.PartitionSpec(policy="bf16:dense:jnp"),
                    sv.PartitionSpec(policy="bf16:sparse24:jnp")),
        placement="spread", batch_slots=2, max_len=64, overlap=overlap)
    runtime = sv.ServingRuntime(p, CFG, spec, rt=rt, **kw)
    trace = wl.WorkloadTrace.from_json(trace_json)
    done = wl.run_trace(runtime, trace)
    assert len(done) == len(trace.events)
    return (wl.token_checksum(done), steps(done), runtime.step_count,
            top.render(runtime))


@pytest.mark.parametrize("overlap", [True, False])
def test_a_jax_trace_replays_to_the_same_checksum(overlap):
    trace = jwl.generate(jwl.WorkloadSpec(
        tenants=3, arrival="bursty", rate=1.0, burst_factor=2.0,
        burst_len=3, steps=8, seed=3, prompt_len=(4, 8), max_new=(2, 6),
        slos=("latency:12", None, "batch:0.9")))
    jp, tp = params()
    want = _replay(jsv, jwl, jtop, trace.to_json(), jp, JRT, overlap)
    got = _replay(tsv, twl, ttop, trace.to_json(), tp, TRT, overlap,
                  device="cpu")
    assert got[:3] == want[:3]
    assert len(got[0]) == 16
    # the frames differ only where a partition row names its policy's
    # backend: the reference's "jnp" is the port's "torch", two letters
    # longer, which moves that row's later columns
    jrows, trows = want[3].splitlines(), got[3].splitlines()
    assert len(trows) == len(jrows)
    for j, t in zip(jrows, trows):
        if j != t:
            assert j.startswith("  p") and ":jnp" in j, (j, t)
            assert t.split() == j.replace(":jnp", ":torch").split()
