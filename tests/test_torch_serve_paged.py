"""The port's paged ServeSession against its dense session and against the
JAX package's paged session, on the reduced llama3-8b.

Paging changes the cache's layout, never its numbers: the paged decode
step gathers each slot's pages back into the dense layout and runs the
dense step's arithmetic, so prefill logits and the active slots' decode
logits are bit-equal to the dense session's. Idle rows are left out: in
the paged step every idle slot writes to the one trash page, so what an
idle row attends to is not defined.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import execution as jex
from repro.models import init_params
from repro.models.layers import RuntimeCfg as JRt
from repro.models.transformer import paged_decode_step as j_paged_step
from repro.runtime import serve_loop as jsl
from repro_torch import bridge
from repro_torch.core import execution as tex
from repro_torch.core.paging import PagesExhausted
from repro_torch.models import transformer as tt
from repro_torch.models.layers import RuntimeCfg as TRt
from repro_torch.runtime import serve_loop as tsl
from test_torch_serve import check_tokens

CFG = get_reduced("llama3-8b")
MAX_LEN, PAGE, SLOTS = 32, 8, 2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _params(dtype):
    jdt, _ = DTYPES[dtype]
    params = init_params(jax.random.PRNGKey(0), CFG, dtype=jdt)
    return params, bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                            CFG)


_PARAMS = {}


def _tparams(dtype):
    if dtype not in _PARAMS:
        _PARAMS[dtype] = _params(dtype)
    return _PARAMS[dtype][1]


def _session(dtype="f32", spec="bf16:dense:torch", paged=True, slots=SLOTS,
             **kw):
    _, tdt = DTYPES[dtype]
    if paged:
        kw.setdefault("page_size", PAGE)
    return tsl.ServeSession(
        _tparams(dtype), CFG, batch_slots=slots, max_len=MAX_LEN,
        rt=TRt(act_dtype=tdt, use_pallas="hopper" in spec),
        policy=tex.parse_policy(spec), paged=paged, device="cpu", **kw)


def _prompts(n, lens=(5, 9, 12), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=(lens[i % len(lens)],))
            .astype(np.int32) for i in range(n)]


def _requests(prompts, max_new=8):
    return [tsl.Request(uid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]


def _drive(sess, reqs):
    """ServeSession.run one step at a time, keeping every prefill's logits
    and every decode step's logits on its active rows."""
    for r in reqs:
        sess.submit(r)
    logits = []
    while sess.queue or sess.n_active:
        while sess.queue and sess.can_admit(sess.queue[0]):
            sess.admit(sess.queue.pop(0))
            logits.append(("prefill", sess.last_logits.clone()))
        active = [i for i, r in enumerate(sess.slots) if r is not None]
        sess.decode_once()
        logits.append(("decode", sess.last_logits[active].clone()))
    return {r.uid: r.out for r in reqs}, logits


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("spec", ["bf16:dense:torch", "bf16:dense:hopper"])
def test_paged_equals_dense_bit_for_bit(dtype, spec):
    prompts = _prompts(5)
    want, wlog = _drive(_session(dtype, spec, paged=False), _requests(prompts))
    got, glog = _drive(_session(dtype, spec), _requests(prompts))
    assert got == want
    assert [k for k, _ in glog] == [k for k, _ in wlog]
    for (kind, g), (_, w) in zip(glog, wlog):
        assert torch.equal(g, w), kind


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("jspec,tspec,use_pallas", [
    ("bf16:dense:jnp", "bf16:dense:torch", False),
    ("bf16:dense:pallas", "bf16:dense:hopper_paged", True),
])
def test_paged_tokens_match_jax_paged_session(jspec, tspec, use_pallas,
                                              dtype):
    """Exact in f32; in bf16 equal up to a flip at a near-tie
    (test_torch_serve.py's rule)."""
    check_tokens(jspec, tspec, use_pallas, dtype, paged=True, page_size=PAGE)


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-4), ("bf16", 3e-2)])
def test_paged_decode_step_matches_jax(dtype, tol):
    """Both packages decode one step from the same paged cache, carried
    over by ``bridge.caches_from_numpy``: logits within
    test_torch_transformer.py's tolerances, pools equal after the write
    (pos exactly; k/v in the same tolerance)."""
    jdt, tdt = DTYPES[dtype]
    jparams, tparams = _params(dtype)
    jrt = JRt(act_dtype=jdt, param_dtype=jdt,
              policy=jex.parse_policy("bf16:dense:jnp"))
    trt = TRt(act_dtype=tdt, policy=tex.parse_policy("bf16:dense:torch"))
    jsess = jsl.ServeSession(jparams, CFG, batch_slots=3, max_len=MAX_LEN,
                             rt=jrt, paged=True, page_size=PAGE)
    for i, p in enumerate(_prompts(2, lens=(7, 8), seed=1)):
        jsess.admit(jsl.Request(uid=i, prompt=p, max_new=8))
    jsess.pager.extend_slot(1, 9)                # slot 1 crosses a page
    jsess._sync_page_map()
    tree = jax.tree.map(np.asarray, jsess.caches)
    tcaches = bridge.caches_from_numpy(tree, CFG)
    pm = np.array(jsess._page_map)
    tok = np.array([[3], [17], [0]], np.int32)
    pos = np.array([7, 8, 0], np.int32)
    jl, jc = j_paged_step(jparams, jnp.asarray(tok), jsess.caches,
                          jnp.asarray(pos), jnp.asarray(pm), CFG, jrt)
    tl, tc = tt.paged_decode_step(tparams, torch.from_numpy(tok).long(),
                                  tcaches, torch.from_numpy(pos),
                                  torch.from_numpy(pm), CFG, trt)
    np.testing.assert_allclose(tl[:2].float().numpy(),
                               np.asarray(jl[:2], np.float32),
                               rtol=tol, atol=tol)
    want = bridge.caches_from_numpy(jax.tree.map(np.asarray, jc), CFG)
    for t, w in zip(tc, want):
        assert torch.equal(t["pos"][:-1], w["pos"][:-1])
        for key in ("k", "v"):
            torch.testing.assert_close(t[key][:-1].float(),
                                       w[key][:-1].float(),
                                       rtol=tol, atol=tol)


def test_freed_pages_are_scrubbed_before_reuse():
    pa, pb = _prompts(2, seed=2)
    sess = _session(slots=1)
    _drive(sess, _requests([pa]))
    assert sess.pager.pages_in_use == 0
    for layer in sess.caches:                    # the trash page left out
        assert (layer["pos"][:-1] == -1).all()
        assert (layer["k"][:-1] == 0).all() and (layer["v"][:-1] == 0).all()
    out_b, _ = _drive(sess, _requests([pb]))
    ref_b, _ = _drive(_session(slots=1), _requests([pb]))
    assert out_b == ref_b


def test_tight_pool_queues_then_serves_every_request():
    """12-token prompts need 2 pages at admission and 3 by the end (12 +
    7 writes); a 3-page pool holds one request at a time."""
    prompts = _prompts(3, lens=(12,), seed=3)
    sess = _session(pages=3)
    got, _ = _drive(sess, _requests(prompts))
    assert sess.pager.stats()["oom_refusals"] == 0
    assert sess.pager.stats()["peak_pages_in_use"] == 3
    want, _ = _drive(_session(paged=False), _requests(prompts))
    assert got == want


def test_a_request_that_never_fits_raises():
    sess = _session(pages=1)
    sess.submit(tsl.Request(uid=0, prompt=_prompts(1, lens=(12,))[0],
                            max_new=4))
    with pytest.raises(PagesExhausted):
        sess.run()
    with pytest.raises(PagesExhausted):
        _session(pages=1).admit(
            tsl.Request(uid=1, prompt=_prompts(1, lens=(12,))[0], max_new=4))


def test_mid_decode_exhaustion_truncates_as_in_jax():
    """One page of 8 positions: a 5-token prompt is cut at position 8,
    after 4 tokens, in both packages; the pool is released."""
    (p,) = _prompts(1, seed=4)
    jparams, _ = _params("f32")
    jsess = jsl.ServeSession(jparams, CFG, batch_slots=1, max_len=MAX_LEN,
                             rt=JRt(act_dtype=jnp.float32,
                                    param_dtype=jnp.float32),
                             policy=jex.parse_policy("bf16:dense:jnp"),
                             paged=True, page_size=PAGE, pages=1)
    jreq = jsl.Request(uid=0, prompt=p.copy(), max_new=16)
    jsess.submit(jreq)
    jsess.run()
    sess = _session(slots=1, pages=1)
    (req,) = _requests([p], max_new=16)
    sess.submit(req)
    sess.run()
    assert req.done and 0 < len(req.out) < 16
    assert req.out == jreq.out
    assert sess.pager.stats()["oom_refusals"] == \
        jsess.pager.stats()["oom_refusals"] >= 1
    assert sess.pager.pages_in_use == 0


@pytest.mark.parametrize("paged", [False, True])
def test_handoff_resumes_with_the_uninterrupted_tokens(paged):
    (p,) = _prompts(1, lens=(9,), seed=5)
    src, dst = _session(paged=paged), _session(paged=paged)
    (req,) = _requests([p], max_new=12)
    src.admit(req)
    for _ in range(4):
        src.decode_once()
    if paged:
        assert dst.can_accept_pages(src.handoff_pages(0), src.page_size)
    export = src.export_slot(0)
    assert src.n_active == 0 and dst.can_accept_handoff(export)
    if paged:
        assert export.pages == src.pager.pages_for(export.pos + 1) == 2
        assert src.pager.pages_in_use == 0
    dst.import_slot(export)
    while not req.done:
        dst.decode_once()
    (ref,) = _requests([p], max_new=12)
    _drive(_session(paged=False), [ref])
    assert req.out == ref.out


def test_handoff_bytes_match_jax_and_layouts_do_not_mix():
    (p,) = _prompts(1, lens=(9,), seed=6)
    jparams, _ = _params("f32")
    nbytes = {}
    for paged in (False, True):
        kw = {"paged": True, "page_size": PAGE} if paged else {}
        jsess = jsl.ServeSession(jparams, CFG, batch_slots=SLOTS,
                                 max_len=MAX_LEN, **kw)
        jsess.admit(jsl.Request(uid=0, prompt=p.copy(), max_new=12))
        tsess = _session(paged=paged)
        tsess.admit(tsl.Request(uid=0, prompt=p.copy(), max_new=12))
        for _ in range(4):
            jsess.decode_once()
            tsess.decode_once()
        want = jsl.export_nbytes(jsess.export_slot(0))
        nbytes[paged] = tsl.export_nbytes(tsess.export_slot(0))
        assert nbytes[paged] == want
    assert nbytes[True] < nbytes[False]
    for src_paged in (False, True):
        src = _session(paged=src_paged)
        src.admit(tsl.Request(uid=0, prompt=p.copy(), max_new=12))
        export = src.export_slot(0)
        with pytest.raises(ValueError):
            _session(paged=not src_paged).import_slot(export)
    src = _session()
    src.admit(tsl.Request(uid=0, prompt=p.copy(), max_new=12))
    with pytest.raises(ValueError):
        _session(page_size=16).import_slot(src.export_slot(0))
    with pytest.raises(ValueError):
        src.export_slot(1)


def test_paged_geometry_is_checked():
    with pytest.raises(ValueError):
        _session(page_size=12)
    sess = _session(pages=None)
    assert sess.pages == SLOTS * MAX_LEN // PAGE
    assert sess.free_slots() == SLOTS
    assert tuple(sess.caches[0]["k"].shape) == \
        (sess.pages + 1, PAGE, CFG.num_kv_heads, CFG.head_dim)
    assert sess._page_map.dtype == torch.int32
