"""The port's autotune store, calibration and ``install`` against the JAX
package's.

The store, its serializers and the calibration are pure data: on the same
samples and records, ``to_dict()`` and ``calibrate(n_cores=...)`` must be
the reference's exactly; an artifact either package writes must load in
the other with identical block lookups; and ``resolve_policy`` under the
two calibrated advisors must pick the same precision. Also the twins of
``tests/test_telemetry.py``'s store tests, the ``profile`` CLI on the CPU
and ``--autotune`` on the serve and train CLIs.
"""
import json

import numpy as np
import pytest
import torch

from repro.core import autotune as jat
from repro.core import characterization as jch
from repro.core import execution as jex
from repro_torch.core import autotune as tat
from repro_torch.core import characterization as tch
from repro_torch.core import concurrency as tcc
from repro_torch.core import execution as tex
from repro_torch.runtime import telemetry as ttel

from torch_train_parity import one_torch_thread  # noqa: F401 (a fixture)

@pytest.fixture(autouse=True)
def restore_port_globals():
    """``install`` changes the port's default advisor and its global block
    cache: give each test the state it found."""
    best = dict(tex.BLOCK_CACHE._best)
    yield
    tex.set_default_advisor(None)
    tex.BLOCK_CACHE._best.clear()
    tex.BLOCK_CACHE._best.update(best)


def _knee_samples(store, knee_tiles, tiles=(256, 512, 1024, 2048)):
    """FP8 loses below ``knee_tiles``, wins at/above it."""
    for t in tiles:
        win = t >= knee_tiles
        store.record_sample("fp8", t, 120.0 if win else 60.0)
        store.record_sample("bf16", t, 100.0)


def _evidence(mod):
    """One set of records of every ingested kind (and some ignored)."""
    R = (jch if mod is jat else tch).Record
    return [
        R("occupancy/fp8/tiles=4", 10.0, {"gflops": 50.0, "tiles": 4,
                                          "precision": "fp8", "m": 512,
                                          "k": 256, "n": 256}),
        R("occupancy/bf16/tiles=4", 11.0, {"gflops": 61.5, "tiles": 4,
                                           "precision": "bf16", "m": 512,
                                           "k": 256, "n": 256}),
        R("occupancy/fp8/tiles=8", 9.0, {"gflops": 99.0, "tiles": 8}),
        R("occupancy/bf16/tiles=8", 9.0, {"gflops": 90.0, "tiles": 8}),
        R("occupancy/fp8/tiles=2", 9.0, {"tiles": 2}),
        R("latency/fp8/128x128x256", 3.0, {}),
        R("latency/int4/128x128x256", 3.0, {}),
        R("latency/bf16/128xx", 3.0, {}),
        R("blocksweep/bf16/128x128x256/128x128x128", 5.0, {}),
        R("blocksweep/bf16/128x128x256/64x64x256", 7.0, {}),
        R("pagedsweep/bf16/4x512x128/1x16x128", 44.8, {}),
        R("pagedsweep/bf16/4x512x128/1x8x128", 50.5, {}),
        R("contention/thin/streams=2", 1.0, {"size": 128}),
    ]


# ---------------------------------------------------------------------------
# Parity: the same evidence gives the same artifact and calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["knee", "never_won", "no_bf16", "records"])
@pytest.mark.parametrize("n_cores", [132, 256])
def test_store_and_calibration_equal_the_reference(case, n_cores, tmp_path):
    stores = []
    for mod in (jat, tat):
        st = mod.AutotuneStore(str(tmp_path / mod.__name__))
        if case == "knee":
            _knee_samples(st, 1024)
            st.record_sample("fp8", 4096, 300.5, m=8, k=9, n=10, source="x")
        elif case == "never_won":
            _knee_samples(st, 10 ** 9)
        elif case == "no_bf16":
            st.record_sample("fp8", 256, 80.0)
        else:
            assert st.add_records(_evidence(mod)) == 9
        st.record_block(384, 768, 384, "fp8", (128, 128, 512), 1e-3)
        stores.append((st, st.calibrate(n_cores=n_cores)))
    (js, jthr), (ts, tthr) = stores
    assert tthr == jthr
    assert ts.to_dict() == js.to_dict()
    assert json.dumps(ts.to_dict(), indent=1) == \
        json.dumps(js.to_dict(), indent=1)
    ja, ta = js.make_advisor(), ts.make_advisor()
    assert (ta.n_cores, ta.fp8_fill_target, ta.demote_below_fill,
            ta.calibrated) == (ja.n_cores, ja.fp8_fill_target,
                               ja.demote_below_fill, ja.calibrated)


def _lookups(cache, shapes):
    return [cache.lookup(m, k, n, prec) for (m, k, n, prec) in shapes]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_loads_the_others_artifact(writer, tmp_path):
    w_mod, r_mod = (jat, tat) if writer == "jax" else (tat, jat)
    st = w_mod.AutotuneStore(str(tmp_path))
    st.add_records(_evidence(w_mod))
    _knee_samples(st, 512)
    st.calibrate(n_cores=132)
    path = st.save()

    back = r_mod.AutotuneStore(str(tmp_path))
    assert back.load() and back.path == path
    assert back.to_dict() == st.to_dict()
    shapes = sorted(st.blocks) + [(128, 256, 128, "bf16"),
                                  (7, 7, 7, "fp8")]
    caches = []
    for mod, store in ((jex, st if writer == "jax" else back),
                       (tex, back if writer == "jax" else st)):
        cache = mod.BlockShapeCache(seed=False)
        assert store.apply(cache) == len(st.blocks)
        caches.append(_lookups(cache, shapes))
    assert caches[1] == caches[0]
    assert caches[1][shapes.index((4, 128, 512, "bf16"))] == (1, 16, 128)


def test_calibrated_advisors_resolve_the_same_precision(tmp_path):
    advisors = []
    for mod in (jat, tat):
        st = mod.AutotuneStore(str(tmp_path / mod.__name__))
        _knee_samples(st, 1024)
        st.calibrate(n_cores=256)
        advisors.append(st.make_advisor(n_cores=256))
    for m, n in ((128, 128), (2048, 4096), (2048, 16384), (4096, 8192),
                 (16, 14336), (8192, 8192)):
        for tenants in (1, 3):
            j = jex.resolve_policy(m, 4096, n, precision="fp8",
                                   tenants=tenants, advisor=advisors[0])
            t = tex.resolve_policy(m, 4096, n, precision="fp8",
                                   tenants=tenants, advisor=advisors[1])
            # the last line (the 2:4 note) names the TPU in the reference
            assert (t.precision, t.sparsity, t.streams,
                    t.rationale[:-1]) == (j.precision, j.sparsity,
                                          j.streams, j.rationale[:-1])


def test_serializers_equal_the_reference(tmp_path):
    assert tat.ENV_DIR == jat.ENV_DIR
    assert (tat.ARTIFACT_NAME, tat.SCHEMA_VERSION, tat.BASELINE_PRECISION) \
        == (jat.ARTIFACT_NAME, jat.SCHEMA_VERSION, jat.BASELINE_PRECISION)
    for v in (1, 2.5, "s", True, None, (1, 2.0, [3, "x"]), np.float32(1.5),
              {"a": 1}):
        assert tat.json_safe(v) == jat.json_safe(v)
    recs = {m: [m.Record("occupancy/fp8/tiles=4", 12.5,
                         {"gflops": 99.0, "tiles": 4, "precision": "fp8",
                          "per_stream_s": (0.1, 0.2)}),
                m.Record("latency/bf16/128x128x128", 3.0,
                         {"tile": "128x128x128"})]
            for m in (jch, tch)}
    assert [tat.record_to_dict(r) for r in recs[tch]] == \
        [jat.record_to_dict(r) for r in recs[jch]]
    tp = tat.dump_records(recs[tch], str(tmp_path / "t" / "out.json"))
    jp = jat.dump_records(recs[jch], str(tmp_path / "j" / "out.json"))
    assert open(tp).read() == open(jp).read()
    assert tat.load_records(tp) == jat.load_records(jp)


# ---------------------------------------------------------------------------
# Twins of the reference's store tests
# ---------------------------------------------------------------------------

def test_store_roundtrip_identical_block_lookups(tmp_path):
    st = tat.AutotuneStore(str(tmp_path))
    src = tex.BlockShapeCache(seed=False)
    src.record(512, 512, 512, torch.bfloat16, (256, 256, 128), 1.5e-3)
    src.record(256, 1024, 256, torch.float8_e4m3fn, (128, 128, 512), 0.8e-3)
    assert st.ingest_cache(src) == 2
    st.save()
    st2 = tat.AutotuneStore(str(tmp_path))
    assert st2.load()
    dst = tex.BlockShapeCache(seed=False)
    assert st2.apply(dst) == 2
    for (m, k, n, dt) in ((512, 512, 512, torch.bfloat16),
                          (256, 1024, 256, torch.float8_e4m3fn)):
        assert dst.lookup(m, k, n, dt) == src.lookup(m, k, n, dt)
    assert tat.AutotuneStore(str(tmp_path)).ingest_cache(
        tex.BlockShapeCache(seed=True)) == 0     # priors stay out


def test_calibration_monotone_under_more_large_samples(tmp_path):
    st = tat.AutotuneStore(str(tmp_path))
    _knee_samples(st, knee_tiles=1024)
    prev = st.calibrate(n_cores=256)["demote_below_fill"]
    for extra in (4096, 8192, 1024, 2048):
        st.record_sample("fp8", extra, 150.0)
        st.record_sample("bf16", extra, 100.0)
        cur = st.calibrate(n_cores=256)["demote_below_fill"]
        assert cur <= prev, (extra, cur, prev)
        prev = cur
    for _ in range(3):
        st.record_sample("fp8", 512, 130.0)
    assert st.calibrate(n_cores=256)["demote_below_fill"] <= prev


def test_install_makes_calibration_the_default(tmp_path):
    st = tat.AutotuneStore(str(tmp_path))
    _knee_samples(st, knee_tiles=1024)
    st.calibrate(n_cores=256)
    st.record_block(384, 768, 384, "fp8", (128, 128, 512), 1e-3)
    st.save()
    prior = tex.resolve_policy(2048, 4096, 4096, precision="fp8",
                               advisor=tcc.OccupancyAdvisor(n_cores=256))
    assert prior.precision == "fp8"             # fill 2.0 >= prior 2.0
    assert tat.install(art_dir=str(tmp_path)) is not None
    assert tex.get_default_advisor().calibrated
    pol = tex.resolve_policy(2048, 4096, 4096, precision="fp8")
    assert pol.precision == "bf16"              # 2.0 < measured 4.0
    assert any("measured" in r for r in pol.rationale)
    assert tex.BLOCK_CACHE.lookup(384, 768, 384, torch.float8_e4m3fn) \
        == (128, 128, 512)
    tex.set_default_advisor(None)
    assert not tex.get_default_advisor().calibrated


def test_install_without_knee_or_artifact_leaves_the_priors(tmp_path):
    assert tat.install(art_dir=str(tmp_path / "missing")) is None
    st = tat.AutotuneStore(str(tmp_path))
    st.record_sample("fp8", 256, 80.0)       # no bf16 at the same tiles
    st.calibrate(n_cores=256)
    assert not st.make_advisor(n_cores=256).calibrated
    st.save()
    assert tat.install(art_dir=str(tmp_path)) is not None
    assert not tex.get_default_advisor().calibrated


def test_default_directory_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv(tat.ENV_DIR, raising=False)
    assert tat.artifact_dir() == "build/repro_torch_autotune"
    assert tat.artifact_dir() != jat.artifact_dir()
    monkeypatch.setenv(tat.ENV_DIR, str(tmp_path))
    assert tat.AutotuneStore().dir == str(tmp_path)


def test_block_sweep_probe_records_ingest_their_fastest_tiling():
    recs = tch.block_sweep_probe(shapes=((128, 128, 128),),
                                 precisions=("bf16",), iters=1,
                                 device="cpu")
    assert recs and all(r.name.startswith("blocksweep/bf16/128x128x128/")
                        for r in recs)
    assert sum(r.derived["winner"] for r in recs) == 1
    st = tat.AutotuneStore()
    assert st.add_records(recs) == len(recs)
    _, secs = st.blocks[(128, 128, 128, "bf16")]
    assert secs == min(r.us_per_call for r in recs) * 1e-6


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def test_profile_quick_writes_reloadable_artifact(tmp_path, capsys):
    from repro_torch.launch import profile
    rc = profile.main(["--quick", "--device", "cpu", "--artifact-dir",
                       str(tmp_path)])
    assert rc == 0
    st = tat.AutotuneStore(str(tmp_path))
    assert st.load(), "profile --quick must write a loadable artifact"
    assert st.thresholds.get("samples", 0) > 0
    assert st.blocks and st.samples
    out = capsys.readouterr().out
    assert "artifact written" in out and "resolve[at-knee" in out
    assert ttel.get_tracer() is None         # the ambient tracer restored
    # the JAX package reads the port's calibration
    assert jat.AutotuneStore(str(tmp_path)).load()


def test_profile_records_its_backend_and_merges_no_other(tmp_path, capsys):
    from repro_torch.launch import profile
    art = str(tmp_path)
    assert profile.main(["--quick", "--device", "cpu", "--backend",
                         "hopper", "--artifact-dir", art]) == 0
    assert tex.default_backend() == "torch"      # restored
    st = tat.AutotuneStore(art)
    assert st.load() and st.samples
    assert st.backends() == {"hopper"}
    assert st.thresholds["backend"] == "hopper"
    assert all(s.source.endswith("@hopper") for s in st.samples)
    assert st.backend_note("hopper") is None
    assert "'hopper'" in st.backend_note("torch")
    out = capsys.readouterr().out
    assert "(backend hopper)" in out
    resolved = [w.split("=")[1] for line in out.splitlines()
                if "resolve[" in line for w in line.split()
                if w.startswith(("prior=", "calibrated="))]
    assert len(resolved) == 4 and all(p.endswith(":hopper")
                                      for p in resolved)
    # the JAX package still reads the tagged artifact, and calibrates the
    # same knee from it
    js = jat.AutotuneStore(art)
    assert js.load()
    assert js.calibrate(n_cores=256) == {
        k: v for k, v in st.calibrate(n_cores=256).items() if k != "backend"}
    # a torch run does not merge into kernel A's evidence
    before = open(st.path).read()
    assert profile.main(["--quick", "--device", "cpu", "--artifact-dir",
                         art]) == 2
    assert "pass --reset or another --artifact-dir" in \
        capsys.readouterr().out
    assert open(st.path).read() == before
    assert ttel.get_tracer() is None


def test_serve_and_train_autotune_print_the_artifact_line(
        tmp_path, monkeypatch, capsys):
    from repro_torch.launch import serve, train
    st = tat.AutotuneStore(str(tmp_path / "art"))
    _knee_samples(st, 1024)
    for s in st.samples:
        s.source = "occupancy@hopper"      # as profile --backend hopper tags
    st.calibrate(n_cores=256)
    st.save()
    monkeypatch.setenv(tat.ENV_DIR, str(tmp_path / "art"))
    serve.main(["--arch", "llama3-8b", "--reduced", "--device", "cpu",
                "--autotune", "--requests", "1", "--max-new", "1"])
    out = capsys.readouterr().out
    assert f"[serve] autotune artifact loaded: {st.path}" in out
    # the knee is kernel A's; this serve resolves under the default torch
    assert ("[serve] autotune artifact calibrated under backend 'hopper'; "
            "policies here resolve under 'torch'") in out
    assert tex.get_default_advisor().calibrated
    tex.set_default_advisor(None)
    monkeypatch.setenv(tat.ENV_DIR, str(tmp_path / "none"))
    train.main(["--arch", "llama3-8b", "--reduced", "--device", "cpu",
                "--autotune", "--steps", "1", "--batch", "1", "--seq", "8"])
    out = capsys.readouterr().out
    assert "[train] autotune artifact not found" in out
    assert not tex.get_default_advisor().calibrated
