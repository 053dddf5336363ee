"""The port's sharding specs (``repro_torch/runtime/sharding.py``) against
the JAX package's, leaf by leaf, for all 10 architectures on both
production meshes, and the shard hook's placement of every tag.

The reference's specs are pure functions of axis sizes: it runs over a
``jax.sharding.AbstractMesh`` (no devices). The port's run over the
``DeviceMesh``es of a fake process group (``launch/mesh.py``), destroyed
at module teardown. A reference spec is normalised to one entry per dim
with the stack dim of its ``layers``/``tail`` leaves dropped (the port
keeps one dict per layer)."""
import functools
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import ARCH_NAMES as J_ARCH_NAMES
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import applicable_shapes as j_applicable
from repro.models import cache_shape as j_cache_shape
from repro.models import params_shape as j_params_shape
from repro.runtime import sharding as jsh
from repro_torch.configs import ARCH_NAMES, ARCHS, SHAPES, applicable_shapes
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as tf
from repro_torch.runtime import sharding as sh
from repro_torch.runtime.sharding import Spec
from torch_train_parity import one_torch_thread  # noqa: F401

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def fake_world():
    yield
    tmesh.destroy()


@functools.lru_cache(maxsize=None)
def jmesh(name):
    return AbstractMesh(*MESHES[name])


@functools.lru_cache(maxsize=None)
def tmesh_of(name):
    return tmesh.make_mesh(*MESHES[name])


@functools.lru_cache(maxsize=None)
def j_params(arch):
    return j_params_shape(JARCHS[arch])


@functools.lru_cache(maxsize=None)
def t_params(arch):
    return tf.params_shape(ARCHS[arch])


def _ref_spec(spec, ndim: int, stacked: bool) -> Spec:
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return Spec(*(entries[1:] if stacked else entries))


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _zip_leaves(params, specs, names):
    """(leaf, spec, reference leaf) per param leaf: a :class:`Spec` is a
    tuple, so the spec tree is walked by the params tree's structure."""
    from repro_torch.core import tree
    out = []
    tree.map_tree(lambda leaf, spec, ref: out.append((leaf, spec, ref)),
                  params, specs, names)
    return out


def test_arch_lists_match():
    assert tuple(ARCH_NAMES) == tuple(J_ARCH_NAMES)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_reference(arch, mesh):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    jp = j_params(arch)
    jspecs = jsh.param_specs(jcfg, jmesh(mesh), jp)
    tp = t_params(arch)
    specs = sh.param_specs(cfg, tmesh_of(mesh), tp)
    names = tf.reference_leaves(tp, cfg)
    from repro_torch.core import tree
    n = 0
    for leaf, spec, ref in _zip_leaves(tp, specs, names):
        stacked = ref.name.startswith(("layers/", "tail/"))
        jleaf = _at(jp, ref.name)
        assert tuple(jleaf.shape[stacked:]) == tuple(leaf.shape), ref.name
        want = _ref_spec(_at(jspecs, ref.name), jleaf.ndim, stacked)
        assert spec == want, (ref.name, spec, want)
        assert len(spec) == leaf.dim()
        n += 1
    assert n == len(tree.leaves(tp))


def _cache_ref_name(cfg, i: int, key: str) -> str:
    n_pat = len(cfg.superlayer_pattern)
    if i < cfg.num_superlayers * n_pat:
        return f"layers/b{i % n_pat}/{key}"
    return f"tail/{key}"


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_specs_equal_reference(arch, mesh):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    for shape in applicable_shapes(cfg):
        if shape.kind != "decode":
            continue
        B, S = shape.global_batch, shape.seq_len
        jc = j_cache_shape(jcfg, B, S)
        jspecs = jsh.cache_specs(jcfg, JSHAPES[shape.name], jmesh(mesh), jc)
        tc = tf.cache_shape(cfg, B, S)
        specs = sh.cache_specs(cfg, shape, tmesh_of(mesh), tc)
        for i, (layer, lspec) in enumerate(zip(tc, specs)):
            for key, t in layer.items():
                name = _cache_ref_name(cfg, i, key)
                jleaf = _at(jc, name)
                assert tuple(jleaf.shape[1:]) == tuple(t.shape), name
                want = _ref_spec(_at(jspecs, name), jleaf.ndim, True)
                assert lspec[key] == want, (shape.name, name, lspec[key],
                                            want)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_and_logits_specs_equal_reference(arch, mesh):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    assert [s.name for s in applicable_shapes(cfg)] == \
        [s.name for s in j_applicable(jcfg)]
    for shape in applicable_shapes(cfg):
        js = JSHAPES[shape.name]
        nd_in = 3 if (cfg.input_mode == "embeddings"
                      and not shape.is_decode) else 2
        got = sh.input_spec(cfg, shape, tmesh_of(mesh)).padded(nd_in)
        want = _ref_spec(jsh.input_spec(jcfg, js, jmesh(mesh)), nd_in,
                         False)
        assert got == want, (shape.name, got, want)
        nd_out = 2 if shape.is_decode else 3
        got = sh.logits_spec(cfg, shape, tmesh_of(mesh)).padded(nd_out)
        want = _ref_spec(jsh.logits_spec(jcfg, js, jmesh(mesh)), nd_out,
                         False)
        assert got == want, (shape.name, got, want)


# ---------------------------------------------------------------------------
# The shard hook
# ---------------------------------------------------------------------------

class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


def _tag_shapes(cfg, shape):
    """(tag, activation shape) at this arch and shape, as the model gives
    them to the hook."""
    B = shape.global_batch
    S = 1 if shape.is_decode else shape.seq_len
    out = [("act_btd", (B, S, cfg.d_model))]
    if cfg.num_heads:
        out.append(("attn_q", (B, S, cfg.num_heads, cfg.head_dim)))
        out.append(("decode_q", (B, 1, cfg.num_heads, cfg.head_dim)))
    if cfg.ssm_kind == "rwkv6":
        hd = cfg.ssm_head_dim
        out.append(("rwkv_v", (B, S, cfg.d_model // hd, hd)))
    if cfg.num_experts:
        T = B * S
        gs = min(cfg.moe_group_size, T)
        from repro_torch.models.moe import capacity
        out.append(("moe_tokens", (T // gs, gs, cfg.d_model)))
        out.append(("moe_dispatch", (T // gs, cfg.num_experts,
                                     capacity(cfg, gs), cfg.d_model)))
    return out


def _reference_tag_spec(fn, tag, shape):
    seen = []

    def wsc(x, sharding):
        seen.append(sharding.spec)
        return x
    orig = jax.lax.with_sharding_constraint
    jax.lax.with_sharding_constraint = wsc
    try:
        fn(tag, _Shape(shape))
    finally:
        jax.lax.with_sharding_constraint = orig
    assert len(seen) <= 1
    return _ref_spec(seen[0], len(shape), False) if seen else None


def _port_tag_spec(fn, mesh, tag, shape):
    from torch.distributed.tensor import DTensor, Replicate
    x = DTensor.from_local(torch.empty(shape, dtype=torch.bfloat16,
                                       device="meta"),
                           mesh, [Replicate()] * mesh.ndim, run_check=False)
    y = fn(tag, x)
    if y is x:
        return None
    return sh.spec_of(y.placements, mesh, len(shape))


MODES = {"default": {}, "no_seq_shard": {"seq_shard_acts": False},
         "decode_2d_tp": {"decode_2d_tp": True},
         "fsdp_only": {"policy": "fsdp_only"}}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ["llama3-8b", "granite-moe-3b-a800m",
                                  "llama4-scout-17b-a16e", "rwkv6-3b",
                                  "gemma3-12b"])
def test_shard_hook_tags_equal_reference(arch, mode):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    kw = MODES[mode]
    n = 0
    for mesh in MESHES:
        for shape in applicable_shapes(cfg):
            js = JSHAPES[shape.name]
            jfn = jsh.make_shard_fn(jcfg, jmesh(mesh), js, **kw)
            tfn = sh.make_shard_fn(cfg, tmesh_of(mesh), shape, **kw)
            for tag, shp in _tag_shapes(cfg, shape):
                want = _reference_tag_spec(jfn, tag, shp)
                got = _port_tag_spec(tfn, tmesh_of(mesh), tag, shp)
                assert got == want, (mesh, shape.name, tag, shp, got, want)
                n += 1
    assert n > 0


def test_shard_hook_passes_plain_tensors_and_unknown_tags():
    cfg, shape = ARCHS["llama3-8b"], SHAPES["train_4k"]
    fn = sh.make_shard_fn(cfg, tmesh_of("single"), shape)
    x = torch.empty((256, 4096, 4096), device="meta")
    assert fn("act_btd", x) is x
    from torch.distributed.tensor import DTensor, Replicate
    mesh = tmesh_of("single")
    d = DTensor.from_local(torch.empty((4, 4), device="meta"), mesh,
                           [Replicate()] * 2, run_check=False)
    assert fn("no_such_tag", d) is d


# ---------------------------------------------------------------------------
# Placements, and the reference's own checks carried over
# ---------------------------------------------------------------------------

def test_two_axes_on_one_dim_follow_gspmd_order():
    """``Spec(("data", "model"))`` puts block i * n_model + j on device
    (i, j), major first as GSPMD does; rank 0 is placed at several
    coordinates to see it."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    tmesh_of("single")                      # the fake world is up
    for coord in [(0, 0), (1, 2), (1, 3)]:
        ranks = list(range(1, 8))
        ranks.insert(coord[0] * 4 + coord[1], 0)
        mesh = DeviceMesh("cpu", torch.tensor(ranks).reshape(2, 4),
                          mesh_dim_names=("data", "model"))
        full = torch.arange(16.0).reshape(16, 1)
        pl = sh.placements(Spec(("data", "model")), mesh, full.shape)
        from torch.distributed.tensor import distribute_tensor
        d = distribute_tensor(full, mesh, pl, src_data_rank=None)
        block = coord[0] * 4 + coord[1]
        assert d.to_local().flatten().tolist() == [2.0 * block,
                                                   2.0 * block + 1]
    with pytest.raises(ValueError, match="against the mesh"):
        sh.placements(Spec(("model", "data")), tmesh_of("single"))
    with pytest.raises(ValueError, match="does not divide"):
        sh.placements(Spec("model"), tmesh_of("single"), (24,))


def test_unknown_leaves_raise():
    cfg = ARCHS["llama3-8b"]
    p = tf.params_shape(cfg)
    p["layers"][0]["attn"]["w_mystery"] = torch.empty((4, 4), device="meta")
    with pytest.raises(KeyError, match="w_mystery"):
        sh.param_specs(cfg, tmesh_of("single"), p)
    caches = [{"mystery": torch.empty((4, 4), device="meta")}]
    with pytest.raises(KeyError, match="mystery"):
        sh.cache_specs(cfg, SHAPES["decode_32k"], tmesh_of("single"),
                       caches)


def _leaves_and_specs(arch, mesh):
    tp = t_params(arch)
    specs = sh.param_specs(ARCHS[arch], tmesh_of(mesh), tp)
    return _zip_leaves(tp, specs, tf.reference_leaves(tp, ARCHS[arch]))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_cache_specs_divisible(arch, mesh):
    m = tmesh_of(mesh)
    for leaf, spec, ref in _leaves_and_specs(arch, mesh):
        sh.placements(spec, m, tuple(leaf.shape))      # raises if not
    cfg = ARCHS[arch]
    for shape in applicable_shapes(cfg):
        if shape.kind == "decode":
            tc = tf.cache_shape(cfg, shape.global_batch, shape.seq_len)
            for layer, lspec in zip(tc, sh.cache_specs(cfg, shape, m, tc)):
                for key, t in layer.items():
                    sh.placements(lspec[key], m, tuple(t.shape))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_large_params_are_sharded(arch):
    """No leaf whose reference stack exceeds 1 GiB is fully replicated on
    the single-pod mesh."""
    cfg = ARCHS[arch]
    n_stack = {}
    for leaf, spec, ref in _leaves_and_specs(arch, "single"):
        n_stack[ref.name] = n_stack.get(ref.name, 0) + 1
    for leaf, spec, ref in _leaves_and_specs(arch, "single"):
        nbytes = math.prod(leaf.shape) * leaf.element_size() \
            * n_stack[ref.name]
        if nbytes > 2 ** 30:
            assert any(e is not None for e in spec), \
                f"{arch}: {ref.name} {tuple(leaf.shape)} replicated"
    assert cfg.param_count() > 0


def test_moe_expert_sharding_split():
    """llama4 (16 experts): expert-parallel on model; granite (40): each
    expert's d_ff sharded instead."""
    l4 = ARCHS["llama4-scout-17b-a16e"]
    spec = sh.param_specs(l4, tmesh_of("single"),
                          t_params("llama4-scout-17b-a16e"))
    assert spec["layers"][0]["moe"]["w_gate"][0] == "model"
    gr = ARCHS["granite-moe-3b-a800m"]
    spec = sh.param_specs(gr, tmesh_of("single"),
                          t_params("granite-moe-3b-a800m"))
    w = spec["layers"][0]["moe"]["w_gate"]
    assert w[0] is None and w[2] == "model"


def test_local_shape_and_meta_placement():
    mesh = tmesh_of("single")
    t = torch.empty((256, 4096), dtype=torch.int32, device="meta")
    d = sh.distribute_meta(t, Spec("data", None), mesh)
    assert tuple(d.shape) == (256, 4096)
    assert tuple(d.to_local().shape) == (16, 4096)
    assert d.to_local().is_meta
