"""Spans inside the port's serving session and training step.

``Tracer.span`` records a timed stretch as an ordinary ``Event`` whose
meta holds its ``span`` id and its ``parent``'s. ``ServeSession`` records
``prefill`` (``admit``) and ``decode`` (dispatch to join) spans and,
under a tracer built with ``phases=True``, their phases;
``make_train_step`` records a ``train_step`` span and its forward,
backward and optimizer phases, timed on the device on a card. These
tests hold the structure only (names, counts, parents, nesting and order
of the intervals), never a share of time. The reference's event stream
(``tests/test_torch_observability.py``) is untouched: a tracer built
without ``phases`` records no phase, and no span meta enters the
reference's fixed stream.
"""
import sys
import threading

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core import execution as ex
from repro_torch.models import init_params
from repro_torch.models.layers import RuntimeCfg
from repro_torch.optim import adamw
from repro_torch.runtime import telemetry as tm
from repro_torch.runtime import traceview as tv
from repro_torch.runtime import train_loop as tl
from repro_torch.runtime.serve_loop import Request, ServeSession

CFG = get_reduced("llama3-8b")
PREFILL = ("prefill.forward", "prefill.first_token", "prefill.cache_write")
DECODE = ("decode.dispatch", "decode.wait", "decode.commit")
_PARAMS = {}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params():
    if "p" not in _PARAMS:
        _PARAMS["p"] = init_params(CFG, torch.Generator().manual_seed(0))
    return _PARAMS["p"]


def _session(tracer, **kw):
    kw.setdefault("max_len", 32)
    if kw.get("paged"):
        kw.setdefault("page_size", 8)
    return ServeSession(_params(), CFG, batch_slots=2,
                        rt=RuntimeCfg(act_dtype=torch.float32),
                        policy=ex.parse_policy("bf16:dense:torch"),
                        telemetry=tracer, device="cpu", **kw)


def _req(uid, n=5, max_new=8):
    g = torch.Generator().manual_seed(uid)
    return Request(uid=uid, prompt=torch.randint(
        0, CFG.vocab_size, (n,), generator=g).tolist(), max_new=max_new)


def _interval(ev):
    return ev.t - ev.wall_s, ev.t


def _check_tree(root, children, kinds):
    """``children`` are ``kinds`` in order, each once, each a child of
    ``root``, inside its interval, siblings in order without overlap."""
    assert [c.kind for c in children] == list(kinds)
    assert root.meta["parent"] == -1
    lo, hi = _interval(root)
    prev_end = lo
    for c in children:
        assert c.meta["parent"] == root.meta["span"]
        a, b = _interval(c)
        assert lo <= a <= b <= hi
        assert a >= prev_end
        prev_end = b


def _by_kind(tracer):
    out = {}
    for ev in tracer.events():
        out.setdefault(ev.kind, []).append(ev)
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_admit_and_decode_record_each_span_once_under_its_parent(paged):
    tr = tm.Tracer(phases=True)
    sess = _session(tr, paged=paged)
    slot = sess.admit(_req(1))
    sess.decode_once()
    evs = _by_kind(tr)
    for kind in ("prefill", "decode") + PREFILL + DECODE:
        assert len(evs[kind]) == 1, kind
    (pre,), (dec,) = evs["prefill"], evs["decode"]
    _check_tree(pre, [evs[k][0] for k in PREFILL], PREFILL)
    _check_tree(dec, [evs[k][0] for k in DECODE], DECODE)
    assert pre.meta["uid"] == 1 and pre.meta["slot"] == slot
    assert pre.m == 5 and dec.m == 2 and dec.meta["n_active"] == 1
    assert _interval(pre)[1] <= _interval(dec)[0]
    # the decode step's phases ride its lane, the prefill's the control
    assert dec.lane == "session"
    assert all(evs[k][0].lane == "session" for k in DECODE)
    assert all(evs[k][0].lane == "" for k in PREFILL)
    ids = [ev.meta["span"] for ev in tr.events()
           if ev.kind != "paging"]
    assert len(set(ids)) == len(ids)


def test_speculative_step_dispatches_draft_and_verify_inside_one_span():
    tr = tm.Tracer(phases=True)
    sess = _session(tr, speculative={"k": 3, "draft_policy": "bf16"})
    sess.admit(_req(2))
    sess.decode_once()
    evs = _by_kind(tr)
    (dec,) = evs["decode"]
    assert dec.meta["spec_k"] == 3
    _check_tree(dec, [evs[k][0] for k in DECODE], DECODE)
    disp_lo, disp_hi = _interval(evs["decode.dispatch"][0])
    drafts = [e for e in evs["dispatch"] if e.meta["label"] == "draft"]
    assert len(drafts) == 1 and disp_lo <= drafts[0].t <= disp_hi
    assert len(evs["spec"]) == 1


def test_the_decode_span_runs_from_dispatch_to_join():
    """Whatever the caller does between the halves lies inside ``decode``
    and outside its phases; the finished slot's free is in the commit."""
    tr = tm.Tracer(phases=True)
    sess = _session(tr)
    sess.admit(_req(3, max_new=2))
    ticket = sess.dispatch_decode()
    with tr.span("caller") as between:
        pass
    done = sess.join_decode(ticket)
    assert [r.uid for r in done] == [3] and sess.n_active == 0
    evs = _by_kind(tr)
    (dec,), (mid,) = evs["decode"], evs["caller"]
    lo, hi = _interval(dec)
    assert lo <= _interval(mid)[0] <= _interval(mid)[1] <= hi
    assert mid.meta["parent"] == -1 and between.id == mid.meta["span"]
    assert _interval(evs["decode.dispatch"][0])[1] <= _interval(mid)[0]
    assert _interval(mid)[1] <= _interval(evs["decode.wait"][0])[0]


def test_a_tracer_without_phases_records_the_reference_stream():
    """One ``prefill`` and one ``decode`` event per call, as the reference
    records them, now spans of their whole calls; no phase."""
    tr = tm.Tracer()
    sess = _session(tr)
    sess.admit(_req(4))
    sess.decode_once()
    sess.decode_once()
    assert tr.counts() == {"prefill": 1, "decode": 2}
    for ev in tr.events():
        assert ev.meta["parent"] == -1 and ev.wall_s > 0
    assert sorted(e.meta["span"] for e in tr.events()) == [0, 1, 2]


def test_decode_with_no_active_slot_records_nothing():
    tr = tm.Tracer(phases=True)
    sess = _session(tr)
    assert sess.decode_once() == []
    assert len(tr) == 0


def _train_state(b=2, s=16):
    opt = adamw.AdamWConfig()
    state = tl.init_state(init_params(CFG, torch.Generator().manual_seed(0)),
                          opt)
    tokens = torch.randint(0, CFG.vocab_size, (b, s),
                           generator=torch.Generator().manual_seed(1))
    return opt, state, {"inputs": tokens, "labels": tokens}


@pytest.mark.parametrize("microbatch,chunks", [(0, 1), (1, 2)])
def test_train_step_records_its_phases_per_step_and_chunk(microbatch,
                                                          chunks):
    tr = tm.Tracer(phases=True)
    opt, state, batch = _train_state()
    step = tl.make_train_step(CFG, opt, RuntimeCfg(), microbatch=microbatch,
                              policy=ex.parse_policy("bf16:dense:torch"),
                              telemetry=tr)
    for _ in range(2):
        state, _ = step(state, batch)
    assert tm.get_tracer() is None           # the ambient one is restored
    evs = [e for e in tr.events() if e.kind != "train_build"]
    roots = [e for e in evs if e.kind == "train_step"]
    assert len(roots) == 2
    want = ["train_step.forward", "train_step.backward"] * chunks \
        + ["train_step.optimizer"]
    for root in roots:
        kids = sorted((e for e in evs
                       if e.meta["parent"] == root.meta["span"]),
                      key=lambda e: e.t)
        _check_tree(root, kids, want)
        assert all("device_s" not in e.meta for e in kids)   # no card
    assert tr.counts() == {"train_build": 1, "train_step": 2,
                           "train_step.forward": 2 * chunks,
                           "train_step.backward": 2 * chunks,
                           "train_step.optimizer": 2}


@pytest.mark.parametrize("spec,kernel,reference", [
    ("bf16:dense:hopper", "linears", "head"),
    ("fp8:dense:hopper", 0, "linears+head"),
    ("bf16:dense:torch", 0, 0)])
def test_backward_phase_counts_each_backward_path(spec, kernel, reference):
    """The backward phase's meta holds the step's calls of each path of
    the kernels' autograd entries: a bf16 linear's backward is kernel A's
    (one per linear), the LM head's f32 cotangent takes the reference's
    products (one per CE chunk), fp8 linears differentiate the reference,
    and the torch backend has no such entry."""
    tr = tm.Tracer(phases=True)
    opt, state, batch = _train_state()
    step = tl.make_train_step(CFG, opt, RuntimeCfg(),
                              policy=ex.parse_policy(spec), telemetry=tr)
    step(state, batch)
    n = {0: 0, "linears": 7 * CFG.num_layers, "head": 1,
         "linears+head": 7 * CFG.num_layers + 1}
    (ev,) = tr.events("train_step.backward")
    assert ev.meta["backward_paths"] == {"kernel": n[kernel],
                                         "reference": n[reference]}


def test_train_step_without_phases_records_one_span_a_step():
    tr = tm.Tracer()
    opt, state, batch = _train_state()
    step = tl.make_train_step(CFG, opt, RuntimeCfg(), telemetry=tr)
    step(state, batch)
    assert tr.counts() == {"train_build": 1, "train_step": 1}


def test_no_tracer_opens_no_span_and_makes_no_cuda_event(monkeypatch):
    """Without a tracer nothing is recorded: no ``Event``, no ``Span``, no
    CUDA event and no synchronize, in serving and in training."""
    def refuse(*a, **k):
        raise AssertionError("called without a tracer")
    for name in ("Event", "Span"):
        monkeypatch.setattr(tm, name, refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    sess = _session(None)
    sess.admit(_req(5, max_new=3))
    sess.decode_once()
    sess.join_decode(sess.dispatch_decode())
    assert sess.completed and tm.get_tracer() is None
    opt, state, batch = _train_state()
    step = tl.make_train_step(CFG, opt, RuntimeCfg(), microbatch=1,
                              policy=ex.parse_policy("bf16:dense:torch"))
    step(state, batch)


class _FakeCudaEvent:
    """A CUDA event that passes when the test says the device has."""
    made, waits, passed = 0, 0, False

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.at = None

    def record(self, stream=None):
        self.at = float(type(self).made)

    def query(self):
        return type(self).passed

    def synchronize(self):
        type(self).waits += 1

    def elapsed_time(self, other):
        return (other.at - self.at) * 1e3       # ms


def test_device_times_are_read_without_waiting_on_the_step(monkeypatch):
    """``device_s`` comes from two CUDA events per span: a later span's
    end reads those the device has passed without waiting, and reading
    the tracer waits for the rest; nothing waits while spans record."""
    fake = type("Fake", (_FakeCudaEvent,), {})
    monkeypatch.setattr(torch.cuda, "Event", fake)
    tr = tm.Tracer(phases=True)
    with tm.phase(tr, "a", device_time=True):
        pass
    with tm.phase(tr, "b", device_time=True):
        pass
    assert fake.made == 4 and fake.waits == 0
    assert all("device_s" not in e.meta for e in tr._ring)
    fake.passed = True
    with tm.phase(tr, "c", device_time=True):
        pass
    assert fake.waits == 0                   # passed: read, not waited
    assert [e.meta.get("device_s") for e in tr._ring] == [1.0, 1.0, 1.0]
    fake.passed = False
    with tm.phase(tr, "d", device_time=True):
        pass
    assert "device_s" not in tr._ring[-1].meta and fake.waits == 0
    (d,) = tr.events("d")                     # the read waits for it
    assert d.meta["device_s"] == 1.0 and fake.waits == 1
    assert not tr._timed
    with tm.phase(tr, "e"):                  # untimed: no CUDA event
        pass
    assert fake.made == 8


def test_span_parents_nest_per_thread_and_drop_on_error():
    tr = tm.Tracer()
    seen = {}

    def other():
        with tr.span("other") as sp:
            seen["parent"] = sp.parent
    with tr.span("outer", lane="l1") as outer:
        with tr.span("inner") as inner:
            t = threading.Thread(target=other)
            t.start()
            t.join()
        with pytest.raises(ValueError):
            with tr.span("failed"):
                raise ValueError("dropped")
        with tr.span("cancelled") as sp:
            sp.cancel()
        late = tr.span("detached")            # never entered: no child
        with tr.span("after") as after:
            pass
    late.end(meta={"x": 1})
    assert seen["parent"] == -1               # another thread's stack
    assert inner.parent == outer.id and after.parent == outer.id
    assert late.parent == outer.id
    evs = _by_kind(tr)
    assert "failed" not in evs and "cancelled" not in evs
    assert evs["inner"][0].lane == "l1"       # a child takes its lane
    assert evs["detached"][0].meta == {"x": 1, "span": late.id,
                                       "parent": outer.id}
    assert tr._open_stack() == []


def test_spans_from_many_threads_keep_their_own_parents():
    """Eight threads nesting spans at once, switching every microsecond:
    every id is unique and every inner span's parent is its own thread's
    outer span."""
    tr = tm.Tracer(capacity=1 << 14)

    def work(i):
        for _ in range(200):
            with tr.span("outer", tenant=str(i)):
                with tr.span("inner", tenant=str(i)):
                    pass
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    evs = tr.events()
    by_id = {e.meta["span"]: e for e in evs}
    assert len(evs) == len(by_id) == 8 * 200 * 2
    for e in evs:
        if e.kind == "inner":
            outer = by_id[e.meta["parent"]]
            assert outer.kind == "outer" and outer.tenant == e.tenant


def test_chrome_trace_nests_each_phase_under_its_span():
    """``launch/serve.py --trace-out``'s export: every span is a slice,
    and each phase lies on its parent's track inside its parent."""
    tr = tm.Tracer(phases=True)
    sess = _session(tr)
    sess.admit(_req(6))
    sess.decode_once()
    sess.decode_once()
    doc = tv.to_chrome_trace(tr)
    slices = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    by_id = {e["args"]["span"]: e for e in slices}
    assert len(by_id) == len(tr) == 2 * 4 + 4
    kids = [e for e in slices if e["args"]["parent"] >= 0]
    assert sorted(e["name"] for e in kids) == sorted(PREFILL + DECODE * 2)
    eps = 2e-3                                # µs: each end rounded apart
    for kid in kids:
        par = by_id[kid["args"]["parent"]]
        assert (kid["pid"], kid["tid"]) == (par["pid"], par["tid"])
        assert par["ts"] - eps <= kid["ts"]
        assert kid["ts"] + kid["dur"] <= par["ts"] + par["dur"] + eps
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert names == {"control", "lane session"}


def test_serve_cli_trace_out_shows_the_decode_phases(tmp_path,
                                                    monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(tm, "_GLOBAL", None)  # the CLI installs its own
    out = tmp_path / "t.json"
    assert serve.main(["--arch", "llama3-8b", "--reduced", "--device", "cpu",
                       "--requests", "2", "--max-new", "3", "--prompt-len",
                       "4", "--slots", "2", "--trace-out", str(out)]) == 0
    slices = [e for e in tv.load(str(out))["traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in slices}
    assert set(DECODE + PREFILL) <= names
