"""Each per-layer reader on a small synthetic record of a run."""
import json
from pathlib import Path

import pytest

from perfbench.harness import bench, trace, work
from perfbench.reference.model import RefCfg

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CONF = json.loads((ROOT / "perfbench/configs/chameleon-34b.json")
                  .read_text())
C = RefCfg.from_config(CONF)

GEMM = "void tile_kernel<Cfg<128, 128, 64>>(Op, Out, int, int)"
LIB = "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32"
FLASH = "void flash_kernel<128>(__nv_bfloat16 const*, int)"
ELT = "void at::native::elementwise_kernel<128, 2>(int)"


def stretch(**extra):
    # 1.0 s of stretch: A 0.30 s, a library GEMM 0.10 s, flash 0.05 s,
    # elementwise 0.05 s; 0.5 s idle
    kernels = [(GEMM, 10.00, 10.30), (LIB, 10.30, 10.40),
               (FLASH, 10.50, 10.55), (ELT, 10.60, 10.65)]
    st = {"t0": 10.0, "t1": 11.0, "wall_s": 1.0, "kernels": kernels,
          "marks": [("decode", 10.0, 10.45), ("admit", 10.45, 10.7)],
          "host_t0": 100.0, "host_t1": 101.0}
    st.update(extra)
    return st


def serve_record():
    spans = [{"name": "admit", "t0": 0.0, "t1": 0.5, "tokens": 2000,
              "profiled": False},
             {"name": "decode", "t0": 0.5, "t1": 0.6, "active": 2,
              "positions": [10, 20], "profiled": False},
             {"name": "decode", "t0": 0.6, "t1": 0.9, "active": 2,
              "positions": [11, 21], "profiled": True}]
    return {"kind": "serve", "ref": C, "window_s": 2.0, "traced_s": 0.5,
            "spans": spans,
            "itl_s": [0.1] * 19 + [1.0],
            "stretch": stretch(admits=[3000], decodes=[[5, 6, 7]])}


def train_record():
    c = RefCfg.from_config(json.loads(
        (ROOT / "perfbench/configs/chameleon-34b-4l.json").read_text()))
    return {"kind": "train", "ref": c, "window_s": 10.0, "traced_s": 2.0,
            "steps": 7, "batch": 4, "seq": 512,
            "spans": [{"name": "step", "t0": 4.0, "t1": 5.5,
                       "profiled": True, "tokens": 2048}],
            "stretch": stretch(steps=1)}


def record_for(metric):
    cells = metric.get("workloads", [])
    train = any(c.endswith(".train") for c in cells)
    return train_record() if train else serve_record()


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_reader_declares_its_entry(m):
    mod = bench.metric_reader(m["name"])
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"],
                                                m["moves"])
    value = mod.read(record_for(m))
    assert isinstance(value, float) and value > 0
    if m["unit"] == "%":
        assert value <= 100.0


@pytest.mark.parametrize("m", [m for m in SPEC["per_layer"]
                               if m["source"] == "device_trace"],
                         ids=lambda m: m["name"])
def test_device_readers_read_nothing_without_a_trace(m):
    rec = record_for(m)
    rec["stretch"] = None
    assert bench.metric_reader(m["name"]).read(rec) is None


def test_values_by_hand():
    s, t = serve_record(), train_record()

    def read(name, rec):
        return bench.metric_reader(name).read(rec)
    assert read("decode_step_ms.serve", s) == pytest.approx(100.0)
    assert read("itl_p95_ms.chat", s) == pytest.approx(
        1e3 * (0.1 + 0.05 * 0.9))
    assert read("idle_share.serve", s) == pytest.approx(50.0)
    assert read("library_gemm_ms.train", t) == pytest.approx(100.0)
    need = work.linears_s(C, 3000, 1) + work.linears_s(C, 3, 3)
    assert read("gemm_roofline.serve", s) == pytest.approx(
        100 * need / 0.4)
    assert read("mfu.serve", s) == pytest.approx(
        100 * (work.prefill_flops(C, 2000) + work.decode_flops(C, [10, 20]))
        / (1.5 * 989e12))
    assert read("mfu.train", t) == pytest.approx(
        100 * 6 * work.train_flops(t["ref"], 4, 512) / (8 * 989e12))


def test_kernel_classes_and_breakdown():
    classes = trace.kernel_classes()
    assert trace.classify(GEMM, classes) == ("gemm", "port")
    assert trace.classify(LIB, classes) == ("gemm", "library")
    assert trace.classify(FLASH, classes) == ("attention", "port")
    assert trace.classify(ELT, classes) == (None, None)
    b = trace.breakdown(stretch())
    assert b["device_ops"][0] == ["tile_kernel", pytest.approx(0.3)]
    assert b["idle_gaps"][0] == ["admit", pytest.approx(0.35)]
    assert len(b["idle_gaps"]) == 3
    assert trace.union_s([(0, 2), (1, 3), (5, 6)]) == 4


def test_read_profile_aligns_and_detects_lost_records():
    events = [("void at::native::spin_kernel(long)", 5.0, 5.00001),
              (GEMM, 5.1, 5.3), (FLASH, 5.4, 5.5), (ELT, 7.0, 7.5)]
    marks = [("decode", 100.05, 100.35)]
    st = trace.read_profile(events, {"gemm": 1, "attention": 1}, 100.0,
                            101.0, marks)
    assert (st["t0"], st["t1"]) == (5.0, 6.0)
    assert st["marks"][0] == ("decode", pytest.approx(5.05),
                              pytest.approx(5.35))
    assert [k[0] for k in st["kernels"]] == [GEMM, FLASH]
    assert trace.read_profile(events, {"gemm": 2, "attention": 1}, 100.0,
                              101.0, marks) is None
