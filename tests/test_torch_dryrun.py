"""The port's distributed dry-run (``repro_torch/launch/{dryrun,perf}.py``)
on reduced configs over fake meshes, and the shape-only trees against
``jax.eval_shape`` of the reference's.

``repro.launch.dryrun`` and ``repro.launch.perf`` set ``XLA_FLAGS`` to 512
host devices when imported, which would change the JAX tests sharing this
worker process; they are not imported here. The fake process group is
destroyed at module teardown."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.models import params_shape as j_params_shape
from repro.optim import adamw as jadam
from repro.runtime import train_loop as jtl
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import tree
from repro_torch.launch import dryrun as dr
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import perf
from repro_torch.launch import roofline as rl
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw as tadam
from repro_torch.runtime import sharding as sh
from repro_torch.runtime import train_loop as ttl
from torch_train_parity import one_torch_thread  # noqa: F401

TRAIN = ShapeConfig("train_small", 64, 8, "train")
PREFILL = ShapeConfig("prefill_small", 64, 8, "prefill")
DECODE = ShapeConfig("decode_small", 64, 8, "decode")


@pytest.fixture(scope="module", autouse=True)
def fake_world():
    yield
    tmesh.destroy()


def mesh24():
    return tmesh.make_mesh((2, 4), ("data", "model"))


def mesh1():
    return tmesh.make_mesh((1, 1), ("data", "model"))


def layers(arch: str, n_super: int):
    cfg = get_reduced(arch)
    return dataclasses.replace(
        cfg, num_layers=n_super * len(cfg.superlayer_pattern)
        + cfg.hybrid_tail_layers)


# ---------------------------------------------------------------------------
# Shape-only trees
# ---------------------------------------------------------------------------

def _by_ref_name(params, cfg):
    """{reference leaf name: [port leaves]} in layer order."""
    out = {}
    tree.map_tree(lambda leaf, ref: out.setdefault(ref.name, []).append(leaf),
                  params, tf.reference_leaves(params, cfg))
    return out


def _at(t, path):
    for k in path.split("/"):
        t = t[k]
    return t


_DT = {jnp.dtype(jnp.float32): torch.float32,
       jnp.dtype(jnp.bfloat16): torch.bfloat16,
       jnp.dtype(jnp.int32): torch.int32}


def _same_tree(port, ref, cfg):
    """Every port leaf has the reference leaf's shape (less its stack dim)
    and dtype, and the stacks have the reference's depth."""
    for name, leaves in _by_ref_name(port, cfg).items():
        j = _at(ref, name)
        stacked = name.startswith(("layers/", "tail/"))
        for t in leaves:
            assert t.is_meta, name
            assert tuple(t.shape) == tuple(j.shape[stacked:]), name
            assert t.dtype == _DT[jnp.dtype(j.dtype)], name
        if stacked:
            assert len(leaves) == j.shape[0], name


@pytest.mark.parametrize("arch", ["llama3-8b", "granite-moe-3b-a800m",
                                  "zamba2-1.2b", "rwkv6-3b"])
@pytest.mark.parametrize("grad_compress,moments", [
    ("none", "f32"), ("int8_ef", "f32"), ("none", "bf16")])
def test_state_shape_equals_reference(arch, grad_compress, moments):
    cfg, jcfg = get_reduced(arch), j_reduced(arch)
    mdt = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}[moments]
    jst = jtl.state_shape(jcfg, jadam.AdamWConfig(moments_dtype=mdt[0]),
                          j_params_shape(jcfg), grad_compress)
    before = torch.random.get_rng_state()
    pshape = tf.params_shape(cfg)
    st = ttl.state_shape(cfg, tadam.AdamWConfig(moments_dtype=mdt[1]),
                         pshape, grad_compress)
    assert torch.equal(torch.random.get_rng_state(), before)
    _same_tree(st.params, jst.params, cfg)
    for part in ("mu", "nu", "master"):
        _same_tree(getattr(st.opt, part), getattr(jst.opt, part), cfg)
    assert st.opt.step.is_meta and st.opt.step.shape == ()
    assert st.opt.step.dtype == torch.int32
    if grad_compress == "int8_ef":
        _same_tree(st.grad_error, jst.grad_error, cfg)
    else:
        assert st.grad_error is None and jst.grad_error is None
    assert tadam.state_shape(pshape, tadam.AdamWConfig()).mu is not None


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma3-12b", "zamba2-1.2b"])
def test_params_and_cache_shape_match_init(arch):
    cfg = get_reduced(arch)
    before = torch.random.get_rng_state()
    ps, cs = tf.params_shape(cfg), tf.cache_shape(cfg, 2, 96)
    assert torch.equal(torch.random.get_rng_state(), before)
    real = tf.init_params(cfg, torch.Generator().manual_seed(0))
    cache = tf.init_cache(cfg, 2, 96)
    for shaped, full in ((ps, real), (cs, cache)):
        a, b = tree.leaves(shaped), tree.leaves(full)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.is_meta and x.shape == y.shape and x.dtype == y.dtype
    n = len(cfg.superlayer_pattern)
    assert tf.superlayer_params_slice(ps, cfg) == ps["layers"][:n]
    assert tf.superlayer_cache_slice(cs, cfg) == cs[:n]


# ---------------------------------------------------------------------------
# The dry-run's counts
# ---------------------------------------------------------------------------

def _spec_bytes(t, spec, mesh):
    return int(np.prod(sh.local_shape(tuple(t.shape), spec, mesh))) \
        * t.element_size()


def _param_bytes(cfg, mesh):
    """(the params' local bytes, the same leaves' in f32) from the specs."""
    pshape = tf.params_shape(cfg)
    pspecs = sh.param_specs(cfg, mesh, pshape)
    own, f32 = [], []
    tree.map_tree(lambda t, s: (own.append(_spec_bytes(t, s, mesh)),
                                f32.append(_spec_bytes(t, s, mesh)
                                           // t.element_size() * 4)),
                  pshape, pspecs)
    return sum(own), sum(f32)


def _expected_argument(cfg, shape, mesh):
    params, f32 = _param_bytes(cfg, mesh)
    bspec = sh.input_spec(cfg, shape, mesh)
    tok = shape.global_batch * shape.seq_len * 4 \
        // sh.axis_size(mesh, bspec[0])
    # the params; f32 master, mu and nu; the step; inputs and labels
    return params + 3 * f32 + 4 + 2 * tok


def test_train_counts_on_a_2x4_mesh():
    """Argument bytes equal the specs' bytes; every layer is traced, so two
    super-layers count one probe more than one; the ratio of useful FLOPs
    is in (0, 1.05]."""
    mesh = mesh24()
    out = {}
    for n in (1, 2):
        cfg = layers("llama3-8b", n)
        rt = dr.make_rt(cfg, mesh, TRAIN)
        traced, layer = dr.lower_train(cfg, TRAIN, mesh, rt, n == 1)
        out[n] = (traced, layer)
        assert traced.memory["argument"] == _expected_argument(cfg, TRAIN,
                                                               mesh)
        mem = traced.memory
        assert mem["per_device_total"] == mem["argument"] + mem["output"] \
            + mem["temp"] - mem["alias"]
        # the state is updated in place: every state output is an input
        assert mem["alias"] > 0.99 * (mem["argument"]
                                      - mem["argument_by_input"]["batch"])
        rec = dr.record({"arch": "llama3-8b", "shape": TRAIN.name}, cfg,
                        TRAIN, traced, layer, mesh.size(), True)
        assert 0 < rec["roofline"]["useful_flops_ratio"] <= 1.05
        assert rec["full"]["collectives"]
    probe = out[1][1]
    assert out[2][0].cost.flops - out[1][0].cost.flops == probe.flops
    assert probe.flops > 0


def test_train_flops_identity_on_one_device():
    """On one device: full matmul FLOPs = L × the super-layer probe's + the
    head's (forward, the checkpointed CE chunk's recompute, two backward
    products: 8·B·S·d·Vp); the embedding and the loss add none."""
    cfg = layers("llama3-8b", 2)
    mesh = mesh1()
    rt = dr.make_rt(cfg, mesh, TRAIN)
    traced, layer = dr.lower_train(cfg, TRAIN, mesh, rt, True)
    B, S = TRAIN.global_batch, TRAIN.seq_len
    head = 8 * B * S * cfg.d_model * cfg.padded_vocab
    assert traced.cost.flops == cfg.num_superlayers * layer.flops + head
    assert traced.cost.wire_bytes == 0
    roof = rl.assemble("llama3-8b", TRAIN.name, 1, traced.cost, None, 2,
                       rl.model_flops_estimate(cfg, TRAIN))
    assert 0 < roof.useful_flops_ratio <= 1.05


@pytest.mark.parametrize("shape", [PREFILL, DECODE], ids=lambda s: s.kind)
def test_prefill_and_decode_trace_on_a_2x4_mesh(shape):
    cfg = layers("llama3-8b", 1)
    mesh = mesh24()
    rt = dr.make_rt(cfg, mesh, shape)
    traced, layer = dr.lower_fn(shape)(cfg, shape, mesh, rt, True)
    assert traced.cost.flops >= layer.flops > 0
    assert traced.memory["argument_by_input"]["params"] == \
        _param_bytes(cfg, mesh)[0]
    if shape.kind == "decode":
        # the caches are written in place and returned: all aliased
        assert traced.memory["alias"] == \
            traced.memory["argument_by_input"]["caches"]


def test_argument_bytes_on_a_2x2x2_mesh():
    """The local bytes of the distributed state on the multi-pod shape
    equal the specs' bytes (batch on pod and data together)."""
    mesh = tmesh.make_mesh((2, 2, 2), ("pod", "data", "model"))
    cfg = get_reduced("llama3-8b")
    pshape = tf.params_shape(cfg)
    pspecs = sh.param_specs(cfg, mesh, pshape)
    dist = sh.distribute_tree(pshape, pspecs, mesh)
    got = sum(t.to_local().numel() * t.element_size()
              for t in tree.leaves(dist))
    want = []
    tree.map_tree(lambda t, s: want.append(_spec_bytes(t, s, mesh)),
                  pshape, pspecs)
    assert got == sum(want)
    tok = sh.distribute_meta(torch.empty((8, 64), dtype=torch.int32,
                                         device="meta"),
                             sh.input_spec(cfg, TRAIN, mesh), mesh)
    assert tok.to_local().shape == (2, 64)


def test_unsupported_layouts_are_listed_not_hidden():
    """Reduced llama3's k/v heads (2) do not divide the model axis (4): a
    k or v split on "model" cannot take the heads apart where it lies,
    and DTensor refuses the head split that GSPMD would reshard, so the
    trace gathers it on "model" alone (the batch stays split on "data"),
    runs the view and lists it."""
    cfg = get_reduced("llama3-8b")
    mesh = mesh24()
    kv = sh.distribute_meta(
        torch.empty((8, 64, cfg.kv_dim), dtype=torch.bfloat16,
                    device="meta"), sh.Spec("data", None, "model"), mesh)
    tr = dr._Trace()
    with tr:
        heads = kv.view(8, 64, cfg.num_kv_heads, cfg.head_dim)
    assert heads.shape == (8, 64, cfg.num_kv_heads, cfg.head_dim)
    assert heads.to_local().shape == (4, 64, cfg.num_kv_heads, cfg.head_dim)
    assert tr.replicated == {"aten.view.default": 1}
    assert tr.replicated_folds == 0
    assert tr.cost().collectives["all-gather"]["count"] > 0
    traced, _ = dr.lower_prefill(cfg, PREFILL, mesh,
                                 dr.make_rt(cfg, mesh, PREFILL), False)
    assert traced.replicated_folds == 0


def test_kernel_backends_are_costed_on_one_device():
    """Under ``hopper`` the meta kernels are costed as kernel A (2·M·N·K,
    its operands and result once): each linear twice per step under
    ``remat="full"`` and its two gradient products once (dX and dW, each
    the forward's operations), the head twice per CE chunk (its f32
    backward is the library's); on a mesh of several devices the variant
    is refused with its reason."""
    cfg = layers("llama3-8b", 2)
    rec = perf.run_variant("llama3-8b", TRAIN.name, "baseline",
                           backend="hopper", mesh=mesh1(), cfg=cfg,
                           shape=TRAIN, with_layer=False)
    assert rec["ok"], rec.get("error")
    gemm = rec["kernels"]["gemm"]
    assert gemm["launches"] == 4 * 7 * cfg.num_layers + 2
    B, S, d = TRAIN.global_batch, TRAIN.seq_len, cfg.d_model
    lin = 2 * B * S * d * (2 * cfg.q_dim + 2 * cfg.kv_dim + 3 * cfg.d_ff)
    assert gemm["flops"] == 4 * cfg.num_layers * lin \
        + 2 * 2 * B * S * d * cfg.padded_vocab
    rec = perf.run_variant("llama3-8b", TRAIN.name, "baseline",
                           backend="hopper", mesh=mesh24(), cfg=cfg,
                           shape=TRAIN, with_layer=False)
    assert not rec["ok"] and "one-device mesh" in rec["error"]
    rec = perf.run_variant("llama3-8b", PREFILL.name, "baseline",
                           backend="hopper", mesh=mesh1(), cfg=cfg,
                           shape=PREFILL, with_layer=False, use_pallas=True)
    assert rec["ok"], rec.get("error")
    fa = rec["kernels"]["flash_attention"]
    assert fa["launches"] == cfg.num_layers
    B, S, h, hd = PREFILL.global_batch, PREFILL.seq_len, cfg.num_heads, \
        cfg.head_dim
    assert fa["flops"] == cfg.num_layers * 4.0 * hd * B * h * S * (S + 1) / 2
    rec = perf.run_variant("llama3-8b", PREFILL.name, "baseline",
                           backend="hopper_sparse24", mesh=mesh1(), cfg=cfg,
                           shape=PREFILL, with_layer=False)
    assert rec["ok"], rec.get("error")
    assert rec["kernels"]["sparse24_gemm"]["launches"] == 7 * cfg.num_layers


def _local_mms(monkeypatch):
    """Count the local ``aten.mm`` calls the dry-run's trace costs (on
    ``meta``; DTensor's sharding propagation runs fake tensors)."""
    seen = []
    count = dr._Trace._count

    def spy(self, func, args, kwargs, out):
        if func is torch.ops.aten.mm.default and args[0].is_meta:
            seen.append(1)
        return count(self, func, args, kwargs, out)
    monkeypatch.setattr(dr._Trace, "_count", spy)
    return seen


def test_remat_dots_keeps_the_linears_on_a_2x4_mesh(monkeypatch):
    """On meta DTensors ``"dots"`` issues no recompute product: its trace
    runs as many local ``aten.mm`` as ``"none"``, fewer than ``"full"``,
    and ``perf``'s ``remat_dots`` costs the baseline's FLOPs less the
    linears' recomputed forward (all but the last down projection, after
    which torch's non-reentrant checkpoint stops recomputing), per device
    of the 2x4 mesh."""
    cfg = layers("llama3-8b", 1)
    mesh = mesh24()
    mms, flops = {}, {}
    seen = _local_mms(monkeypatch)
    for remat in ("none", "dots", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        seen.clear()
        traced, _ = dr.lower_train(c, TRAIN, mesh, dr.make_rt(c, mesh, TRAIN),
                                   False)
        mms[remat], flops[remat] = len(seen), traced.cost.flops
    assert mms["dots"] == mms["none"] < mms["full"]
    assert flops["none"] <= flops["dots"] < flops["full"]
    recs = {v: perf.run_variant("llama3-8b", TRAIN.name, v, mesh=mesh,
                                cfg=cfg, shape=TRAIN, with_layer=False)
            for v in ("baseline", "remat_dots")}
    B, S, d = TRAIN.global_batch, TRAIN.seq_len, cfg.d_model
    linears = 2 * B * S * d * (2 * cfg.q_dim + 2 * cfg.kv_dim + 2 * cfg.d_ff)
    assert recs["baseline"]["full"]["flops"] \
        - recs["remat_dots"]["full"]["flops"] == linears / mesh.size()


def test_folds_and_splits_run_on_the_local_shards():
    """A (batch, seq) activation split on (data, model) folds to rows split
    on both and splits back to its own layout, on each device's own
    elements, whether or not DTensor would run the view; a split whose
    next dim the mesh dim does not divide (2 k/v heads over 4) is left to
    DTensor."""
    from torch.distributed.tensor import Shard
    mesh = mesh24()
    x = sh.distribute_meta(torch.empty((8, 64, 128), device="meta"),
                           sh.Spec("data", "model", None), mesh)
    view = torch.ops.aten.view.default
    assert dr._view_placements(x, (512, 128)) == ([Shard(0), Shard(0)],
                                                  True)
    assert dr._view_placements(x, (8, 64, 2, 64)) == (
        [Shard(0), Shard(1)], False)
    tr = dr._Trace()
    with tr:
        flat = tr._local_view(view, (x, [-1, 128]), {}, True)
    assert flat.shape == (512, 128) and flat.to_local().shape == (64, 128)
    assert dr._view_placements(flat, (8, 64, 128)) == (
        [Shard(0), Shard(1)], True)
    kv = sh.distribute_meta(torch.empty((8, 64, 64), device="meta"),
                            sh.Spec("data", None, "model"), mesh)
    assert dr._view_placements(kv, (8, 64, 2, 32)) is None
    assert tr.bytes == 0 and tr.replicated_folds == 0


def test_decode_writes_the_cache_by_rows(monkeypatch):
    """The decode step's cache write (``index_select`` and ``index_copy_``
    into the rows split on (data, model)) runs where the rows lie: its
    collectives move the new rows only, never the cache, and its ops cost
    the same bytes whatever the cache's length."""
    import traceback
    cfg = layers("llama3-8b", 1)
    mesh = mesh24()
    sizes, row_bytes = [], []
    collective_of, count = rl.collective_of, dr._Trace._count

    def spy(func, args, out):
        c = collective_of(func, args, out)
        if c is not None and any(f.name == "_dense_write"
                                 for f in traceback.extract_stack()):
            sizes.append(int(np.prod(c.shape)))
        return c

    def spy_count(self, func, args, kwargs, out):
        before = self.bytes
        count(self, func, args, kwargs, out)
        if func in (torch.ops.aten.index_select.default,
                    torch.ops.aten.index_copy_.default):
            row_bytes.append(self.bytes - before)
    monkeypatch.setattr(rl, "collective_of", spy)
    monkeypatch.setattr(dr._Trace, "_count", spy_count)
    B, kvh, hd = 8, cfg.num_kv_heads, cfg.head_dim
    costs = {}
    for S in (64, 128):
        shape = ShapeConfig("decode_small", S, B, "decode")
        sizes.clear()
        row_bytes.clear()
        dr.lower_decode(cfg, shape, mesh, dr.make_rt(cfg, mesh, shape),
                        False)
        assert sizes and max(sizes) <= B * kvh * hd
        costs[S] = list(row_bytes)
    assert costs[64] == costs[128] and len(costs[64]) == 6
    assert max(costs[64]) <= 8 * B + 2 * B * kvh * hd * 2


def test_row_ops_cost_their_rows():
    """``index_select`` and ``index_copy_`` on a plain meta cache cost the
    index and the rows, whatever the cache's size."""
    for n in (1024, 4096):
        cache = torch.empty((n, 8, 128), dtype=torch.bfloat16, device="meta")
        idx = torch.empty((4,), dtype=torch.int64, device="meta")
        tr = dr._Trace()
        with tr:
            rows = cache.index_select(0, idx)
            cache.index_copy_(0, idx, rows)
        assert tr.bytes == 2 * (32 + 2 * 4 * 8 * 128 * 2)


def test_perf_cli_mesh_and_exit_code(monkeypatch, tmp_path):
    """``--mesh 1x1`` hands ``run_variant`` a 1x1 mesh (the kernel
    backends' one), and the CLI exits 1 when a variant fails."""
    got = []

    def fake(arch, shape, variant, backend=None, mesh=None, **kw):
        got.append((variant, backend, None if mesh is None
                    else tuple(mesh.shape)))
        return {"ok": variant == "baseline"}
    monkeypatch.setattr(perf, "run_variant", fake)
    out = str(tmp_path / "p.jsonl")
    assert perf.main(["--arch", "llama3-8b", "--shape", "train_4k",
                      "--variant", "baseline", "--backend", "hopper",
                      "--mesh", "1x1", "--out", out]) == 0
    assert got == [("baseline", "hopper", (1, 1))]
    assert perf.main(["--arch", "llama3-8b", "--shape", "train_4k",
                      "--variant", "baseline,fp8", "--out", out]) == 1


@pytest.mark.parametrize("variant", list(perf.VARIANTS))
def test_every_perf_variant_runs(variant):
    cfg = layers("llama3-8b", 1)
    shape = DECODE if variant == "decode_2d_tp" else TRAIN
    rec = perf.run_variant("llama3-8b", shape.name, variant, mesh=mesh24(),
                           cfg=cfg, shape=shape, with_layer=False)
    assert rec["ok"], rec.get("error")
    assert rec["roofline"]["step_s"] > 0
    assert len(perf.VARIANTS) == 11


def test_cli_records_a_failed_cell_and_exits_1(tmp_path, capsys,
                                              monkeypatch):
    """A cell that fails is recorded ``ok: false`` with its error, and the
    CLI exits 1."""
    def broken(shape):
        def lower(*a, **k):
            raise RuntimeError("a cell that cannot be traced")
        return lower
    monkeypatch.setattr(dr, "lower_fn", broken)
    out = tmp_path / "d.jsonl"
    rc = dr.main(["--arch", "llama3-8b", "--shape", "train_4k",
                  "--out", str(out)])
    assert rc == 1
    assert "0/1 cells OK" in capsys.readouterr().out
    import json
    rec = json.loads(out.read_text())
    assert rec["ok"] is False and "cannot be traced" in rec["error"]
    assert rec["mesh"] == "single" and rec["chips"] == 256
