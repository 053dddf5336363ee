"""The port's policy resolver, overlap planner and lane-dispatched matmul
against the JAX package's.

``resolve_policy`` must pick the reference's policy (the JAX backend names
read as the port's) over a grid of shapes, precisions, tenancy and
latency sensitivity; ``OverlapPlanner.plan`` the same groups on the same
candidates; ``dispatch_matmul`` the same result as ``matmul``. A
``policy="auto"`` session must resolve the reference's policy and serve
its tokens.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.core import concurrency as jcc
from repro.core import execution as jex
from repro.runtime import serve_loop as jsl
from repro.runtime import telemetry as jtel
from repro_torch.core import concurrency as tcc
from repro_torch.core import execution as tex
from repro_torch.kernels import registry as treg
from repro_torch.runtime import serve_loop as tsl
from repro_torch.runtime import telemetry as ttel
from torch_runtime_parity import (
    CFG, JRT, MAX_LEN, TRT, outs, params, requests)

SHAPES = [(1, 64, 128), (4, 4096, 14336), (16, 128, 512), (256, 1024, 4096),
          (512, 4096, 14336), (8, 100, 256)]


def _port_spec(pol):
    return ":".join(tex.BACKEND_ALIASES.get(t, t)
                    for t in pol.full_spec().split(":"))


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_resolve_policy_matches_jax(m, k, n):
    grid = itertools.product(("fp8", "bf16"), (1, 3, 6), (False, True),
                             (None, "pallas", "jnp"), (None, 2))
    for prec, tenants, lat, backend, streams in grid:
        kw = dict(precision=prec, tenants=tenants, latency_sensitive=lat,
                  backend=backend, streams=streams)
        want = jex.resolve_policy(m, k, n, advisor=jcc.OccupancyAdvisor(256),
                                  **kw)
        got = tex.resolve_policy(m, k, n, advisor=tcc.OccupancyAdvisor(256),
                                 **kw)
        assert got.full_spec() == _port_spec(want), kw
        assert len(got.rationale) == len(want.rationale)


def test_resolve_policy_records_to_the_tracer():
    tr = ttel.Tracer()
    pol = tex.resolve_policy(4, 4096, 14336, precision="bf16", tenants=4,
                             latency_sensitive=True, tracer=tr)
    (ev,) = tr.events("resolve")
    assert (ev.m, ev.k, ev.n, ev.backend) == (4, 4096, 14336, pol.backend)
    tex.set_default_advisor(tcc.OccupancyAdvisor(1, calibrated=True))
    try:
        assert tex.get_default_advisor().n_cores == 1
    finally:
        tex.set_default_advisor(None)
    assert tex.grid_tiles(4, 14336) == jex.grid_tiles(4, 14336) == 112


def _candidates(mod, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(rng.integers(1, 7))):
        ema = None if rng.random() < 0.2 else float(rng.uniform(1e-3, 2e-2))
        out.append(mod.OverlapCandidate(
            index=i, sparsity="sparse24" if rng.random() < 0.4 else "dense",
            ema_s=ema, allowed=bool(rng.random() > 0.1)))
    return out


@pytest.mark.parametrize("max_imbalance,homogeneous",
                         [(8.0, True), (1.5, True), (2.0, False)])
def test_overlap_planner_matches_jax(max_imbalance, homogeneous):
    jp = jex.OverlapPlanner(max_imbalance=max_imbalance,
                            pair_homogeneous=homogeneous)
    tp = tex.OverlapPlanner(max_imbalance=max_imbalance,
                            pair_homogeneous=homogeneous)
    for seed in range(40):
        want = jp.plan(_candidates(jex, seed))
        got = tp.plan(_candidates(tex, seed))
        assert (got.groups, got.serial, got.n_overlapped) == \
            (want.groups, want.serial, want.n_overlapped), seed


def test_planner_candidates_read_the_tracer_ema():
    shape = (2, 128, 512, "bf16")
    for mod, tel in ((jex, jtel), (tex, ttel)):
        tr = tel.Tracer()
        for w in (0.01, 0.02):
            tr.record("decode", m=2, k=128, n=512, precision="bf16",
                      wall_s=w)
        planner = mod.OverlapPlanner()
        assert planner.candidate(0, shape=shape).ema_s is None
        got = planner.candidate(0, shape=shape, tracer=tr).ema_s
        assert got == pytest.approx(tr.shape_latency_ema()[shape])
        assert got == pytest.approx(0.25 * 0.02 + 0.75 * 0.01)


@pytest.mark.parametrize("policy", ["bf16:dense:torch", "fp8:dense:hopper",
                                    "bf16:dense:hopper"])
def test_dispatch_matmul_equals_matmul(policy):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 64, generator=g).to(torch.bfloat16)
    w = torch.randn(64, 96, generator=g).to(torch.bfloat16)
    pol = tex.parse_policy(policy)
    lane = tcc.ExecutionLane("t", device="cpu")
    tr = ttel.Tracer()
    h = tex.dispatch_matmul(x, w, pol, lane=lane, overlap_group=3, tracer=tr)
    assert torch.equal(h.join(), tex.matmul(x, w, pol))
    assert h.overlap_group == 3 and h.lane == "t" and h.done
    (ev,) = tr.events("matmul")
    assert (ev.m, ev.k, ev.n, ev.meta["lane"]) == (15, 64, 96, "t")
    packed = tex.pack_weight(w)
    h = tex.dispatch_matmul(x, packed, pol)        # throwaway lane on x's device
    assert torch.equal(h.join(), tex.matmul(x, packed, pol))


def test_registry_kinds_and_entries_match_jax():
    from repro.kernels import registry as jreg
    assert treg.KINDS == jreg.KINDS
    be = treg.get_backend("torch")
    for kind in treg.KINDS:
        assert be.entry(kind) is getattr(be, kind)
    with pytest.raises(KeyError):
        be.entry("int4")


def test_auto_policy_session_matches_jax():
    """``policy="auto"`` resolves the reference's policy for the session's
    decode GEMM and serves the reference's tokens (replaces the case of
    test_torch_serve.py that expected it to raise)."""
    jp, tp = params()
    jreqs, treqs = requests(0, n=3, max_new=5)
    jsess = jsl.ServeSession(jp, CFG, batch_slots=2, max_len=MAX_LEN,
                             rt=JRT, policy="auto", auto_backend="jnp")
    tsess = tsl.ServeSession(tp, CFG, batch_slots=2, max_len=MAX_LEN,
                             rt=TRT, policy="auto", auto_backend="jnp",
                             device="cpu")
    assert tsess.policy.full_spec() == _port_spec(jsess.policy)
    assert tsess.policy.sparsity == "sparse24"
    for sess, reqs in ((jsess, jreqs), (tsess, treqs)):
        for r in reqs:
            sess.submit(r)
        sess.run()
    assert outs(treqs) == outs(jreqs)
    # a spec string is parsed, as the reference's runtime does
    s = tsl.ServeSession(tp, CFG, batch_slots=1, max_len=8, rt=TRT,
                         policy="fp8:dense:pallas", device="cpu")
    assert s.policy.spec() == "fp8:dense:hopper"
