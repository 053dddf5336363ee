"""The port's ``top`` dashboard against the JAX package's.

``render`` is a pure report→text function: its bars, attainment cells and
the frame of a runtime must be the reference's (twin of
``tests/test_controller.py``'s top test). Frames of runtimes that replayed
one trace from one bridged init are compared in
``tests/test_torch_workload.py`` and, with the SLO controller's line,
``tests/test_torch_observability.py``. ``main`` drains its synthetic
tenants on the CPU.
"""
import numpy as np

from repro.launch import top as jtop
from repro.runtime import server as jsv
from repro_torch.launch import top as ttop
from repro_torch.runtime import server as tsv

from torch_runtime_parity import CFG, JRT, TRT, params
from torch_train_parity import one_torch_thread  # noqa: F401 (a fixture)


def test_bars_and_attainment_cells_equal_the_reference():
    for frac in np.linspace(-0.5, 1.5, 41).tolist() + [1 / 3, 0.03125]:
        for width in (1, 8, 10, 16):
            assert ttop._bar(frac, width) == jtop._bar(frac, width)
    for att in (None, 0.0, 0.5, 0.999, 1.0, 1.2):
        assert ttop._fmt_att(att) == jtop._fmt_att(att)


def test_controller_off_frame_equals_the_reference():
    """A fresh runtime with one tenant and no controller: the column
    header stays, no controller summary; the frame is the reference's."""
    jp, tp = params()
    frames = []
    for sv, top, p, rt, kw in ((jsv, jtop, jp, JRT, {}),
                               (tsv, ttop, tp, TRT, {"device": "cpu"})):
        spec = sv.ServingSpec(partitions=(sv.PartitionSpec(admission="fifo"),
                                          sv.PartitionSpec()),
                              batch_slots=2, max_len=64, metrics=True)
        runtime = sv.ServingRuntime(p, CFG, spec, rt=rt, **kw)
        runtime.add_tenant("t0")
        frames.append(top.render(runtime, clock=1.25))
    assert frames[1] == frames[0]
    assert "CTRL" in frames[1] and "checks" not in frames[1]
    assert "t=1.2s" in frames[1]


def test_main_drains_its_synthetic_tenants_on_the_cpu(capsys):
    assert ttop.main(["--device", "cpu", "--once", "--requests", "4",
                      "--max-new", "4", "--prompt-len", "4", "--paged",
                      "--slo", "latency:12"]) == 0
    out = capsys.readouterr().out
    assert "repro-top · 2 partition(s)" in out
    assert "latency:12" in out and "util" in out
    assert "tokens 16 · pending 0" in out       # every staggered arrival
    assert out.rstrip().splitlines()[-1].startswith("[top] drained in ")
