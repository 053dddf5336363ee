"""The port's roofline (``repro_torch/launch/roofline.py``) against the JAX
package's: the analytic estimates for every arch × applicable shape, the
collective wire formulas, and the term assembly with the port's H100
constants set to the reference's, all exact. ``repro.launch.roofline``
sets no XLA flags, so importing it here leaves the JAX tests alone."""
import dataclasses
import importlib.util
import itertools
import json
from pathlib import Path

import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.launch import roofline as jrl
from repro_torch.configs import ARCH_NAMES, ARCHS, applicable_shapes
from repro_torch.launch import roofline as rl
from torch_train_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_estimates_equal_reference(arch):
    for shape in applicable_shapes(ARCHS[arch]):
        js = JSHAPES[shape.name]
        assert rl.model_flops_estimate(ARCHS[arch], shape) == \
            jrl.model_flops_estimate(JARCHS[arch], js)
        assert rl.min_bytes_estimate(ARCHS[arch], shape) == \
            jrl.min_bytes_estimate(JARCHS[arch], js)


KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


@pytest.mark.parametrize("kind", KINDS)
def test_collective_wire_formulas_equal_reference(kind):
    for dtype, shape, g in itertools.product(
            ("bf16", "f32", "s32", "f8e4m3fn", "pred"),
            ((), (7,), (16, 4096), (2, 3, 5)), (1, 2, 16, 256)):
        a = rl.Collective(kind, dtype, shape, g)
        b = jrl.Collective(kind, dtype, shape, g)
        assert a.result_bytes == b.result_bytes
        assert a.wire_bytes == b.wire_bytes
        assert a.wire_bytes_bf16 == b.wire_bytes_bf16
    colls = [rl.Collective(kind, "bf16", (8, 8), 4),
             rl.Collective(kind, "f32", (3,), 16)]
    jcolls = [jrl.Collective(c.kind, c.dtype, c.shape, c.group_size)
              for c in colls]
    assert rl.collective_wire_bytes(colls) == sum(c.wire_bytes
                                                  for c in jcolls)
    assert rl.collective_wire_bytes_bf16(colls) == \
        sum(c.wire_bytes_bf16 for c in jcolls)
    assert rl.collective_summary(colls) == {
        kind: {"count": 2, "wire_bytes": sum(c.wire_bytes for c in jcolls)}}


@pytest.fixture
def reference_constants(monkeypatch):
    monkeypatch.setattr(rl, "PEAK_FLOPS", jrl.PEAK_FLOPS)
    monkeypatch.setattr(rl, "HBM_BW", jrl.HBM_BW)
    monkeypatch.setattr(rl, "NVLINK_BW", jrl.ICI_BW)


def _costs(mod, f, b, w, wb):
    return mod.CellCost(f, b, w, {"all-gather": {"count": 1,
                                                 "wire_bytes": w}}, wb)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_assemble_and_terms_equal_reference(reference_constants, kind):
    for chips, n_bodies, layer in itertools.product(
            (1, 256, 512), (1, 32, 126), (None, (3e9, 5e8, 7e6, 0.0))):
        full = (4.1e12, 2.2e11, 3.3e9, 1.7e9)
        got = rl.assemble("a", "s", chips, _costs(rl, *full),
                          layer and _costs(rl, *layer), n_bodies, 9.9e15,
                          min_bytes=1.6e10, kind=kind)
        want = jrl.assemble("a", "s", chips, _costs(jrl, *full),
                            layer and _costs(jrl, *layer), n_bodies, 9.9e15,
                            min_bytes=1.6e10, kind=kind)
        assert got.to_dict() == want.to_dict()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_h100_constants_and_one_source(tmp_path):
    """The port's terms use one H100 SXM's data-sheet rates, and
    ``chip_smoke.py``'s kernel bounds read the same module."""
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.NVLINK_BW) == (989e12, 3.35e12,
                                                        450e9)
    assert rl.PEAK_OPS_S["bf16"] == rl.PEAK_FLOPS
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    hbm, ops = smoke.peaks()
    assert hbm == rl.HBM_BW and ops == rl.PEAK_OPS_S
    ms, by = smoke.bound_ms(3.35e9, 989e9, "bf16")
    assert (ms, by) == (pytest.approx(1.0), "bytes")


def test_report_equals_reference(tmp_path):
    recs = []
    for arch, shape, mesh in (("llama3-8b", "train_4k", "single"),
                              ("llama3-8b", "train_4k", "multi"),
                              ("rwkv6-3b", "decode_32k", "single")):
        r = {"arch": arch, "shape": shape, "mesh": mesh, "ok": True,
             "memory": {"per_device_total": 3.5 * 2 ** 30}}
        if mesh == "single":
            r["roofline"] = jrl.assemble(
                arch, shape, 256, _costs(jrl, 1e12, 1e11, 1e9, 5e8), None,
                1, 2e15).to_dict()
        recs.append(r)
    recs.append({"arch": "x", "shape": "y", "mesh": "single", "ok": False})
    path = tmp_path / "dry.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\nnot json\n")
    assert rl.report(str(path)) == jrl.report(str(path))


def test_hlo_dtype_names():
    assert rl.hlo_dtype(torch.bfloat16) == "bf16"
    assert rl.hlo_dtype(torch.float8_e4m3fn) == "f8e4m3fn"
    assert rl.hlo_dtype(torch.int32) == "s32"
    assert rl.hlo_dtype(torch.bool) == "pred"
