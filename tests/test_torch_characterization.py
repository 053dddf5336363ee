"""The port's characterization sweeps and block-cache seeding against the
JAX package's.

For the same arguments every sweep must give the reference's record
names, ``derived`` keys and every derived value that is not a time (one
``winner`` per block-sweep group, whichever it is); ``block_candidates``,
``occupancy_threshold``, ``parse_blocksweep_name`` and
``seed_cache_from_records`` must equal the reference's exactly. Times are
not compared. Twins of ``tests/test_system.py``'s sweep test,
``tests/test_execution.py``'s block-cache tests and
``tests/test_telemetry.py``'s block-sweep tests. The block cache is inert
under ``hopper``: blocks on a policy change nothing the kernels receive.
"""
import inspect
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import characterization as jch
from repro.core import execution as jex
from repro.runtime import telemetry as jtel
from repro_torch.core import characterization as tch
from repro_torch.core import execution as tex
from repro_torch.kernels import fp8_matmul as tfm
from repro_torch.kernels import gemm_plan
from repro_torch.kernels import sparse24_matmul as tsm
from repro_torch.runtime import telemetry as ttel

from torch_train_parity import one_torch_thread  # noqa: F401 (a fixture)

# derived values that are times (or rates from times)
TIMED = {"gflops", "norm_to_best", "per_tile_us", "winner", "dilation",
         "fairness", "cv", "overlap_eff"}


def _untimed(recs):
    return [(r.name, sorted(r.derived),
             {k: v for k, v in r.derived.items() if k not in TIMED})
            for r in recs]


def _both(name, **kw):
    return (getattr(jch, name)(**kw),
            getattr(tch, name)(**kw, device="cpu"))


def test_occupancy_sweep_records_match_the_reference():
    want, got = _both("occupancy_sweep", tile_counts=(1, 2), tile_m=64,
                      k=64, n=64, precisions=("fp32", "bf16", "fp8"),
                      iters=2)
    assert len(got) == 6
    assert _untimed(got) == _untimed(want)
    assert all(r.us_per_call > 0 and "," in r.csv() for r in got)
    th = tch.occupancy_threshold(got)
    assert set(th) == {"fp32", "bf16", "fp8"}


def test_shape_sweep_and_latency_probe_records_match_the_reference():
    want, got = _both("shape_sweep", total_mn=128 * 128, k=64,
                      ratios=(1.0, 4.0), precisions=("bf16", "fp8"), iters=2)
    assert len(got) == 4 and _untimed(got) == _untimed(want)
    want, got = _both("latency_probe",
                      tile_shapes=((128, 128, 128), (128, 256, 64)),
                      precisions=("fp32", "bf16", "fp8"), chain=3, iters=2)
    assert len(got) == 6 and _untimed(got) == _untimed(want)
    assert all(r.us_per_call > 0 for r in got)


def test_contention_sweep_records_match_the_reference():
    kw = dict(sizes={"thin": 32, "thick": 64}, stream_counts=(1, 2),
              iters=2)
    want, got = _both("contention_sweep", **kw)
    assert len(got) == 4 and _untimed(got) == _untimed(want)


def test_block_sweep_probe_matches_the_reference():
    """One group per (shape, precision), the candidate tilings of the
    reference, exactly one winner each; the records ingest alike."""
    kw = dict(shapes=((128, 128, 128), (128, 256, 512)),
              precisions=("bf16", "fp8"), backend="jnp", iters=1)
    want, got = _both("block_sweep_probe", **kw)
    assert _untimed(got) == _untimed(want)
    groups = {}
    for r in got:
        groups.setdefault(r.name.rsplit("/", 1)[0], []).append(r)
    assert len(groups) == 4
    assert all(sum(r.derived["winner"] for r in g) == 1
               for g in groups.values())
    with pytest.raises(ValueError, match="not in policy precisions"):
        tch.block_sweep_probe(precisions=("fp32",), device="cpu")


@pytest.mark.parametrize("prec", ["fp8", "bf16", "fp32", "fp16"])
def test_block_candidates_equal_the_reference(prec):
    dims = (64, 128, 256, 512, 1024)
    for m, n, k in itertools.product(dims, repeat=3):
        for cap in (1, 2, 3):
            assert tch.block_candidates(m, n, k, prec, cap) == \
                jch.block_candidates(m, n, k, prec, cap)
    assert (128, 256, 512) in tch.block_candidates(128, 256, 512, "fp8")
    assert tch.block_candidates(128, 128, 128, "bf16") == [(128, 128, 128)]


def test_occupancy_threshold_equals_the_reference():
    rng = np.random.default_rng(0)
    rows = [(p, t, float(rng.uniform(0.1, 1.0)))
            for p in ("fp8", "bf16") for t in (1, 2, 4, 8, 16)]
    for frac in (0.0, 0.5, 0.9, 1.0, 1.1):
        out = []
        for mod in (jch, tch):
            recs = [mod.Record(f"occupancy/{p}/tiles={t}", 1.0,
                               {"tiles": t, "precision": p,
                                "norm_to_best": v}) for p, t, v in rows]
            out.append(mod.occupancy_threshold(recs, frac))
        assert out[1] == out[0]


def test_time_fn_counts_its_calls_on_the_host_clock():
    before = tch.CALLS
    dt = tch._time_fn(lambda a: a * 2, torch.ones(4), iters=3, warmup=2)
    assert dt > 0 and tch.CALLS - before == 5


# ---------------------------------------------------------------------------
# raw_matmul, the default policy and backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", ["fp32", "bf16", "fp8"])
def test_raw_matmul_matches_the_reference(prec):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((16, 32)).astype(np.float32) * 4
    b = rng.standard_normal((32, 8)).astype(np.float32) * 4
    jt, tt = jch.PRECISIONS[prec], tch.PRECISIONS[prec]
    # fp8 values are exact in f32: go through the JAX cast's bytes
    ja, jb = jnp.asarray(a).astype(jt), jnp.asarray(b).astype(jt)
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).to(tt)
    tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).to(tt)
    jtr, ttr = jtel.Tracer(), ttel.Tracer()
    jprev, tprev = jtel.set_tracer(jtr), ttel.set_tracer(ttr)
    try:
        want = np.asarray(jex.raw_matmul(ja, jb, backend="jnp"))
        got = tex.raw_matmul(ta, tb, backend="jnp").numpy()
    finally:
        jtel.set_tracer(jprev)
        ttel.set_tracer(tprev)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    (je,), (te,) = jtr.events(), ttr.events()
    assert (te.m, te.k, te.n, te.precision, te.backend, te.meta) == \
        (je.m, je.k, je.n, je.precision, je.backend, je.meta)


def test_default_policy_and_backend_precedence_matches_the_reference():
    from repro.models.layers import RuntimeCfg as JRt
    from repro_torch.models.layers import RuntimeCfg as TRt
    from repro_torch.configs import get_reduced
    cfg = get_reduced("llama3-8b")

    def trail(ex, rt, backend, pin):
        out = []
        prev_b, prev_p = ex.default_backend(), ex.get_default_policy()
        try:
            out.append(ex.policy_from(cfg, rt).spec())
            ex.set_default_backend(backend)
            out.append(ex.get_default_policy().spec())
            out.append(ex.policy_from(cfg, rt).spec())
            ex.set_default_policy(ex.parse_policy(pin))
            out.append(ex.policy_from(cfg, rt).spec())
            with ex.policy_scope(ex.parse_policy("fp8:dense")):
                out.append(ex.get_default_policy().spec())
                out.append(ex.get_scope_policy().spec())
            assert ex.get_scope_policy() is None
        finally:
            ex.set_default_policy(None)
            ex.set_default_backend(prev_b)
        assert ex.get_default_policy() == prev_p
        return out

    want = trail(jex, JRt(), "ref", "bf16:sparse24:jnp")
    got = trail(tex, TRt(), "ref", "bf16:sparse24:jnp")
    assert got == [s.replace(":jnp", ":torch") for s in want]
    assert tex.default_backend() == "torch"
    with pytest.raises(KeyError):
        tex.set_default_backend("nonexistent")


# ---------------------------------------------------------------------------
# Block cache: seeding, and its inertness under hopper
# ---------------------------------------------------------------------------

NAMES = ["blocksweep/bf16/128x256x512/128x128x128",
         "blocksweep/fp8/1x2x3/4x5x6", "blocksweep/int4/1x2x3/4x5x6",
         "blocksweep/bf16/128x256/1x2x3", "blocksweep/bf16/axbxc/1x2x3",
         "blocksweep/bf16/1x2x3/1x2", "pagedsweep/bf16/4x512x128/1x16x128",
         "latency/bf16/128x128x128", "blocksweep/bf16/1x2x3/1x2x3/x"]


def test_sweep_name_parsers_equal_the_reference():
    for n in NAMES:
        assert tex.parse_blocksweep_name(n) == jex.parse_blocksweep_name(n)
        assert tex.parse_pagedsweep_name(n) == jex.parse_pagedsweep_name(n)


def _records(mod):
    rows = [("latency/fp8/128x128x256", 3.0), ("occupancy/fp8/tiles=4", 1.0),
            ("latency/bf16/256x256x128", 2.0), ("latency/int4/8x8x8", 1.0),
            ("blocksweep/bf16/128x128x256/128x128x256", 9.0),
            ("blocksweep/bf16/128x128x256/128x128x128", 5.0),
            ("blocksweep/bf16/128x128x256/64x64x256", 7.0),
            ("pagedsweep/bf16/4x512x128/1x16x128", 4.0)]
    return [mod.Record(n, us, {}) for n, us in rows]


def test_seed_cache_from_records_equals_the_reference():
    jc, tc = jex.BlockShapeCache(seed=False), tex.BlockShapeCache(seed=False)
    assert tex.seed_cache_from_records(_records(tch), tc) == \
        jex.seed_cache_from_records(_records(jch), jc) == 5
    assert tc.entries() == jc.entries()
    assert tc.lookup(128, 256, 128, torch.float8_e4m3fn) == (128, 128, 256)
    assert tc.lookup(128, 256, 128, torch.bfloat16) == (128, 128, 128)
    # a seeded cache keeps the Table-3 priors beside the evidence
    jc, tc = jex.BlockShapeCache(), tex.BlockShapeCache()
    jex.seed_cache_from_records(_records(jch), jc)
    tex.seed_cache_from_records(_records(tch), tc)
    assert tc.entries() == jc.entries()


class _Spy:
    """Records the operands and arguments every kernel wrapper receives."""

    def __init__(self, monkeypatch):
        self.calls = []
        for mod, name in ((tfm, "fp8_matmul"), (tsm, "sparse24_matmul")):
            real = getattr(mod, name)

            def spy(*args, _real=real, _name=name, **kw):
                self.calls.append((_name, [a.clone() if torch.is_tensor(a)
                                           else a for a in args], kw))
                return _real(*args, **kw)
            monkeypatch.setattr(mod, name, spy)


@pytest.mark.parametrize("spec", ["bf16:dense:hopper", "fp8:dense:hopper",
                                  "bf16:dense:hopper_sparse24",
                                  "bf16:sparse24:hopper"])
def test_blocks_are_inert_under_hopper(spec, monkeypatch):
    """A policy's block_m/n/k change neither what the kernel wrappers
    receive nor a bit of the output: the kernels plan their own tiles
    (``gemm_plan.plan``, a function of M, N, K, kind and SM count)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 24, 64), generator=gen).to(torch.bfloat16)
    w = torch.randn((64, 48), generator=gen).to(torch.bfloat16)
    pol = tex.parse_policy(spec)
    if pol.sparsity == "sparse24":
        w = tex.pack_weight(w)
    spy = _Spy(monkeypatch)
    plain = tex.matmul(x, w, pol)
    n_plain = len(spy.calls)
    outs = []
    for blocks in ((16, 16, 16), (256, 256, 512), (24, 48, 64)):
        outs.append(tex.matmul(x, w, tex.parse_policy(
            "x".join(map(str, blocks)), base=pol)))
    assert n_plain >= 1 and len(spy.calls) == 4 * n_plain
    first = spy.calls[:n_plain]
    for i in range(1, 4):
        again = spy.calls[i * n_plain:(i + 1) * n_plain]
        for (n0, a0, k0), (n1, a1, k1) in zip(first, again):
            assert n0 == n1 and k0 == k1 and len(a0) == len(a1)
            for u, v in zip(a0, a1):
                assert torch.equal(u, v) if torch.is_tensor(u) else u == v
    for out in outs:
        assert torch.equal(out.view(torch.int16), plain.view(torch.int16))
    assert list(inspect.signature(gemm_plan.plan).parameters) == \
        ["M", "N", "K", "kind", "sm_count", "batch"]
