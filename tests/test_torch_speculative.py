"""Speculative decoding in the port against plain greedy decode and against
the JAX package's speculative session, on the reduced llama3-8b, and on the
MoE, local/global and recurrent stacks (whose states each step replaces
whole: the draft puts them back, the verify keeps each slot's snapshot at
its accepted step).

The contract is the reference's: a speculative session commits exactly the
plain greedy stream (dense and paged, fp8 and fp8:sparse24 drafts, any k,
a slot that ends mid-commit at ``max_len`` included), and a rejected draft
leaves no trace in the cache. The port's draft writes the session's cache
in place where the reference's writes are dropped, so the cache tests here
run the draft for real before the verify and hold the result to plain
decode's cache bit for bit.

Both packages run from the same JAX init (bridged bit for bit). In f32 the
tokens and the acceptance totals equal JAX's exactly; in bf16 the two
stacks round differently (test_torch_serve.py), so a token may flip only at
a near-tie of the port's plain decode, while the port's speculative tokens
still equal its own plain tokens exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import execution as jex
from repro.core import speculative as jspv
from repro.models import init_params
from repro.models.layers import RuntimeCfg as JRt
from repro.runtime import serve_loop as jsl
from repro_torch import bridge
from repro_torch.core import execution as tex
from repro_torch.core import speculative as tspv
from repro_torch.models import transformer as tt
from repro_torch.models.layers import RuntimeCfg as TRt
from repro_torch.runtime import serve_loop as tsl
from test_torch_serve import NEAR_TIE, _margin

CFG = get_reduced("llama3-8b")
MAX_LEN, PAGE, SLOTS = 24, 8, 2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
_PARAMS = {}


def _params(dtype):
    if dtype not in _PARAMS:
        jdt, _ = DTYPES[dtype]
        params = init_params(jax.random.PRNGKey(0), CFG, dtype=jdt)
        _PARAMS[dtype] = (params, bridge.params_from_numpy(
            jax.tree.map(np.asarray, params), CFG))
    return _PARAMS[dtype]


def _session(dtype="f32", *, paged=False, speculative=None, slots=SLOTS,
             **kw):
    _, tdt = DTYPES[dtype]
    if paged:
        kw.setdefault("page_size", PAGE)
    return tsl.ServeSession(
        _params(dtype)[1], CFG, batch_slots=slots, max_len=MAX_LEN,
        rt=TRt(act_dtype=tdt), policy=tex.parse_policy("bf16:dense:torch"),
        paged=paged, speculative=speculative, device="cpu", **kw)


def _jax_session(dtype="f32", *, paged=False, speculative=None):
    jdt, _ = DTYPES[dtype]
    kw = dict(paged=True, page_size=PAGE) if paged else {}
    return jsl.ServeSession(
        _params(dtype)[0], CFG, batch_slots=SLOTS, max_len=MAX_LEN,
        rt=JRt(act_dtype=jdt, param_dtype=jdt),
        policy=jex.parse_policy("bf16:dense:jnp"), speculative=speculative,
        **kw)


def _prompts():
    """Two accept-friendly prompts (a repeated pair the draft predicts)
    and two random ones, so acceptance differs between slots within one
    verify step."""
    rng = np.random.default_rng(3)
    return [np.array([5 + 2 * i, 9 + 2 * i] * 3, np.int32) for i in range(2)] \
        + [rng.integers(0, CFG.vocab_size, 6).astype(np.int32)
           for _ in range(2)]


# request 1 ends on max_new (mid-commit for k > 1 when its drafts are
# accepted); the others run into max_len (18 decode positions after a
# 6-token prompt), where a k-deep commit is cut short too
MAX_NEW = (32, 11, 32, 32)


def _run(sess, module, tenants=("a", "b", "a", "b")):
    for uid, (p, n) in enumerate(zip(_prompts(), MAX_NEW)):
        sess.submit(module.Request(uid=uid, prompt=p.copy(), max_new=n,
                                   tenant=tenants[uid]))
    sess.run()
    return {r.uid: list(r.out) for r in sess.completed}


# ---------------------------------------------------------------------------
# The exactness contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("draft", ["fp8", "fp8:sparse24"])
@pytest.mark.parametrize("paged", [False, True])
def test_committed_tokens_equal_plain_decode_and_jax(paged, draft, k):
    """f32: the port's speculative tokens equal its plain greedy tokens and
    JAX's speculative session's, and so do the acceptance totals (per
    tenant: steps, drafted, accepted, committed)."""
    spec = {"k": k, "draft_policy": draft}
    plain = _run(_session(paged=paged), tsl)
    sess = _session(paged=paged, speculative=spec)
    got = _run(sess, tsl)
    jsess = _jax_session(paged=paged, speculative=spec)
    want = _run(jsess, jsl)
    assert got == plain == want
    assert [len(got[u]) for u in range(4)] == [19, 11, 19, 19]
    assert sess.spec_totals == jsess.spec_totals
    if k == 1:
        assert sess.spec_totals == {} and sess._spec_fns == {}
    else:
        assert sum(t["committed"] for t in sess.spec_totals.values()) \
            == sum(len(o) - 1 for o in got.values())


def test_bf16_tokens_equal_plain_and_jax_up_to_a_near_tie():
    """bf16: speculative == plain exactly in the port; against JAX's
    speculative session a request may flip only where the port's plain
    decode had a top-2 margin under the near-tie bound."""
    spec = {"k": 4, "draft_policy": "fp8"}
    plain = _session("bf16")
    margins = {}
    for uid, (p, n) in enumerate(zip(_prompts(), MAX_NEW)):
        plain.submit(tsl.Request(uid=uid, prompt=p.copy(), max_new=n))
    while plain.queue or plain.n_active:
        while plain.queue and plain.can_admit(plain.queue[0]):
            req = plain.queue.pop(0)
            plain.admit(req)
            margins[(req.uid, 0)] = _margin(plain.last_logits[0])
        active = [(i, r, len(r.out)) for i, r in enumerate(plain.slots)
                  if r is not None]
        plain.decode_once()
        for i, r, n in active:
            margins[(r.uid, n)] = _margin(plain.last_logits[i])
    ref = {r.uid: list(r.out) for r in plain.completed}
    got = _run(_session("bf16", speculative=spec), tsl)
    want = _run(_jax_session("bf16", speculative=spec), jsl)
    assert got == ref
    for uid in want:
        flip = next((i for i, (a, b) in enumerate(zip(got[uid], want[uid]))
                     if a != b), None)
        if flip is not None:
            assert margins[(uid, flip)] < NEAR_TIE["bf16"], (uid, flip)


def test_k1_is_the_plain_path():
    """``k = 1`` builds no draft, records no acceptance and runs the plain
    step: the same tokens and the same last logits as a session with no
    spec."""
    a, b = _session(speculative=1), _session()
    for sess in (a, b):
        for uid, p in enumerate(_prompts()[:2]):
            sess.submit(tsl.Request(uid=uid, prompt=p.copy(), max_new=6))
        sess._admit_from_queue()
        sess.decode_once()
    assert torch.equal(a.last_logits, b.last_logits)
    a.run()
    b.run()
    assert [r.out for r in a.completed] == [r.out for r in b.completed]
    assert a.spec_totals == {} and a._spec_fns == {}


def test_speculation_refuses_sampled_decode():
    with pytest.raises(ValueError):
        _session(speculative=2, temperature=0.7)


# ---------------------------------------------------------------------------
# The in-place draft and the rollback
# ---------------------------------------------------------------------------

def _prefilled(paged, slots=1):
    """A session with one request admitted in slot 0 and two plain steps
    taken (so the rollback has history to keep); the rest idle."""
    sess = _session(paged=paged, slots=slots)
    prompt = np.random.default_rng(2).integers(0, CFG.vocab_size, 6)
    sess.admit(tsl.Request(uid=0, prompt=prompt.astype(np.int32),
                           max_new=32))
    for _ in range(2):
        sess.decode_once()
    return sess


def _clone(caches):
    return [{key: t.clone() for key, t in c.items()} for c in caches]


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()]) \
        if t.is_floating_point() else t


def _caches_equal(a, b, paged):
    """Bit-equal leaves; on a paged session the trash page is scratch."""
    cut = slice(None, -1) if paged else slice(None)
    return all(torch.equal(_bits(x[key][cut]), _bits(y[key][cut]))
               for x, y in zip(a, b) for key in ("k", "v", "pos"))


@pytest.mark.parametrize("n_acc", [0, 2])
@pytest.mark.parametrize("paged", [False, True])
def test_cache_after_the_draft_and_verify_equals_plain_decode(paged, n_acc):
    """The fp8 draft writes rows pos .. pos+k-2 of the session's cache in
    place; then a k = 4 verify whose drafts match the plain greedy tokens
    for ``n_acc`` steps (then miss) must leave the cache bit-equal to
    ``n_acc + 1`` plain decode steps, and commit their tokens."""
    k = 4
    sess = _prefilled(paged)
    pos = torch.as_tensor(sess.slot_pos.astype(np.int64))
    if paged:      # grown for the k candidates, as the session does
        sess.pager.extend_slot(0, min(int(pos[0]) + k, MAX_LEN))
        sess._sync_page_map()
    pm = (sess._page_map,) if paged else ()
    step = tt.paged_decode_step if paged else tt.decode_step
    plain = _clone(sess.caches)
    tok, greedy = sess.tokens, []
    for j in range(n_acc + 1):
        logits, _ = step(sess.params, tok, plain, pos + j, *pm, sess.cfg,
                         sess.rt)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        greedy.append(int(tok[0, 0]))
    draft = tspv.make_draft_step(sess.cfg, sess.rt, tex.parse_policy("fp8"),
                                 k - 1, paged=paged)
    before = _clone(sess.caches)
    draft(sess.params, sess.tokens, sess.caches, pos, *pm)
    assert not _caches_equal(sess.caches, before, paged)   # it wrote
    bad = (greedy[-1] + 1) % CFG.vocab_size
    seq = torch.tensor([[int(sess.tokens[0, 0])] + greedy[:n_acc]
                        + [bad] * (k - 1 - n_acc)], dtype=torch.int32)
    multi = tt.paged_multi_decode_step if paged else tt.multi_decode_step
    nxt, g, acc, rolled = multi(sess.params, seq, sess.caches, pos,
                                torch.ones(1, dtype=torch.bool), *pm,
                                sess.cfg, sess.rt)
    assert int(acc[0]) == n_acc
    assert g[0, :n_acc + 1].tolist() == greedy
    assert int(nxt[0, 0]) == greedy[-1]
    assert rolled is sess.caches
    assert _caches_equal(rolled, plain, paged)


def test_idle_slot_is_untouched_by_the_verify():
    """An idle slot (active False) never accepts a draft, even one that
    matches its greedy tokens, and its cache ends as plain decode leaves
    it: one write at its parked position."""
    sess = _prefilled(paged=False, slots=2)
    pos = torch.as_tensor(sess.slot_pos.astype(np.int64))
    plain = _clone(sess.caches)
    logits, _ = tt.decode_step(sess.params, sess.tokens, plain, pos,
                               sess.cfg, sess.rt)
    g0 = torch.argmax(logits, -1).to(torch.int32)
    seq = torch.stack([sess.tokens[:, 0], g0, g0, g0], dim=1)
    active = torch.tensor([True, False])
    _, _, acc, rolled = tt.multi_decode_step(sess.params, seq, sess.caches,
                                             pos, active, sess.cfg, sess.rt)
    assert int(acc[1]) == 0
    for r, p in zip(rolled, plain):
        for key in ("k", "v", "pos"):
            assert torch.equal(r[key][1], p[key][1])


def test_paged_trim_leaves_no_stale_row():
    """A k = 4 paged session over-grows pages for the candidates and trims
    them after a verify that rejects into them (the 2:4 draft is rejected
    often): once drained, the pool is scrubbed, and the
    reused pages serve the next request with the plain tokens."""
    sess = _session(paged=True, slots=1,
                    speculative={"k": 4, "draft_policy": "fp8:sparse24"})
    first, second = _prompts()[2:]
    sess.submit(tsl.Request(uid=0, prompt=first.copy(), max_new=10))
    sess.run()
    assert sess.pager.trim_count > 0
    assert sess.pager.pages_in_use == 0
    for c in sess.caches:
        assert (c["pos"][:-1] == -1).all()
        assert (c["k"][:-1] == 0).all() and (c["v"][:-1] == 0).all()
    sess.submit(tsl.Request(uid=1, prompt=second.copy(), max_new=10))
    sess.run()
    ref = _session(paged=True, slots=1)
    ref.submit(tsl.Request(uid=1, prompt=second.copy(), max_new=10))
    ref.run()
    assert sess.completed[-1].out == ref.completed[-1].out


def test_paged_step_falls_back_to_plain_when_the_pool_is_short():
    """The batch-wide check: when the free pages cannot cover every slot's
    k candidates, the step runs plain decode instead (and a slot the pool
    cannot grow even so finishes truncated, as in plain decode). Every
    request's tokens are a prefix of the plain stream."""
    sess = _session(paged=True, speculative=4, pages=4)
    depths = []
    grow = sess._grow_pages
    sess._grow_pages = lambda k=1: (depths.append(k), grow(k))[1]
    got = _run(sess, tsl)
    assert 1 in depths and 4 in depths
    plain = _run(_session(paged=True), tsl)
    for uid, out in got.items():
        assert out and out == plain[uid][:len(out)]


# ---------------------------------------------------------------------------
# The spec surface and the depth controller, against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    "none", "int", "dict", "instance", "bool", "unknown_field", "k0",
    "thresholds", "reprobe", "roundtrip", "draft_backend"])
def test_spec_surface(case):
    S = tspv.SpecDecodeSpec
    s = S.from_any({"k": 2, "draft_policy": "fp8:sparse24"})
    if case == "none":
        assert S.from_any(None) is None
    elif case == "int":
        assert S.from_any(3).k == 3
    elif case == "dict":
        assert s.spec_key() == "fp8:sparse24:torch"
    elif case == "instance":
        assert S.from_any(s) is s
    elif case == "bool":
        with pytest.raises(TypeError):
            S.from_any(True)
    elif case == "unknown_field":
        with pytest.raises(ValueError):
            S.from_any({"k": 2, "nope": 1})
    elif case == "k0":
        with pytest.raises(ValueError):
            S(k=0)
    elif case == "thresholds":
        with pytest.raises(ValueError):
            S(grow_above=0.2, shrink_below=0.5)
    elif case == "reprobe":
        with pytest.raises(ValueError):
            S(k=2, reprobe_interval=-1)
    elif case == "roundtrip":
        assert S.from_any(s.to_dict()) == S(k=2,
                                            draft_policy="fp8:sparse24:torch")
    elif case == "draft_backend":
        # parsed with no base: "fp8" takes the port's default backend, as
        # JAX's takes its own, whatever the session's policy
        assert S(draft_policy="fp8").resolved().backend == "torch"
        assert jspv.SpecDecodeSpec(draft_policy="fp8").resolved().backend \
            == "jnp"
        assert S(draft_policy="fp8:dense:hopper").spec_key() \
            == "fp8:dense:hopper"
        assert S(draft_policy="fp8:dense:pallas").spec_key() \
            == "fp8:dense:hopper"


def _scenario_grow_and_shrink(ak):
    for _ in range(8):
        ak.observe("t", 3, 0)
        yield ak.on_step()
    for _ in range(10):
        ak.observe("t", 3, 3)
        yield ak.on_step()
    ak.observe("slow", 3, 0)
    for _ in range(8):
        ak.observe("t", 3, 3)
        ak.observe("slow", 3, 0)
        yield ak.on_step()
    yield dict(ak.desired)
    ak.forget("slow")
    yield ak.k


def _scenario_floor_sticky(ak):
    for _ in range(8):
        ak.observe("t", 3, 0)
        yield ak.on_step()
    for _ in range(40):
        yield ak.on_step()
    yield ak.reprobes


def _scenario_reprobe(ak):
    for _ in range(8):
        ak.observe("t", 3, 0)
        yield ak.on_step()
    for _ in range(12):
        yield ak.on_step()
    for _ in range(8):
        ak.observe("t", 3, 3)
        yield ak.on_step()
    for _ in range(10):
        ak.observe("t", 3, 0)
        yield ak.on_step()
    for _ in range(12):
        yield ak.on_step()
    yield ak.reprobes


def _scenario_reprobe_capped(ak):
    ak.observe("t", 1, 0)
    ak.ema["t"] = 0.0
    for _ in range(5):
        yield ak.on_step()


SCENARIOS = {
    "grow_and_shrink": (_scenario_grow_and_shrink,
                        dict(k=4, adaptive=True, interval=2, ema_alpha=1.0)),
    "floor_sticky": (_scenario_floor_sticky,
                     dict(k=4, adaptive=True, interval=2, ema_alpha=1.0)),
    "reprobe": (_scenario_reprobe,
                dict(k=4, adaptive=True, interval=2, ema_alpha=1.0,
                     reprobe_interval=3)),
    "reprobe_capped": (_scenario_reprobe_capped,
                       dict(k=1, adaptive=True, interval=1, ema_alpha=1.0,
                            reprobe_interval=1)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_adaptive_k_follows_the_reference(name):
    """The reference's four AdaptiveK scenarios, each depth after each
    tick equal to JAX's controller, and its end states as the reference's
    tests pin them."""
    run, kw = SCENARIOS[name]
    got = list(run(tspv.AdaptiveK(tspv.SpecDecodeSpec(**kw))))
    want = list(run(jspv.AdaptiveK(jspv.SpecDecodeSpec(**kw))))
    assert got == want
    if name == "grow_and_shrink":
        assert got[7] == 1 and got[17] == 4
        assert got[-2] == {"t": 4, "slow": 1} and got[-3] == 1
        assert got[-1] == 4
    elif name == "floor_sticky":
        assert got[7] == 1 and set(got[8:-1]) == {1} and got[-1] == 0
    elif name == "reprobe":
        assert 2 in got[8:20] and max(got[8:20]) == 2
        assert got[27] == 4 and got[-1] > 1
    else:
        assert got == [1] * 5


def test_adaptive_session_actuates_depth():
    sess = _session(slots=1, speculative={"k": 4, "adaptive": True})
    assert sess.adaptive_k is not None and sess._next_spec_k() == 4
    sess.adaptive_k.k = 1                 # the controller hit the floor
    assert sess._next_spec_k() == 1
    sess.submit(tsl.Request(uid=0, prompt=_prompts()[0].copy(), max_new=4))
    sess.run()
    assert sess.spec_totals == {}         # plain steps while floored
    assert sess.adaptive_k.steps > 0      # ticked on the plain steps
    assert _session(speculative=4).adaptive_k is None


# ---------------------------------------------------------------------------
# The MoE and local/global stacks
# ---------------------------------------------------------------------------

BLOCK_MAX_LEN, BLOCK_PAGE = 96, 16


def _block_sessions(arch, paged, spec):
    """The port's and JAX's f32 sessions of a reduced arch, one init."""
    cfg = get_reduced(arch)
    params = init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    kw = dict(paged=True, page_size=BLOCK_PAGE) if paged else {}
    port = tsl.ServeSession(
        tparams, cfg, batch_slots=SLOTS, max_len=BLOCK_MAX_LEN,
        rt=TRt(act_dtype=torch.float32),
        policy=tex.parse_policy("bf16:dense:torch"), speculative=spec,
        device="cpu", **kw)
    ref = jsl.ServeSession(
        params, cfg, batch_slots=SLOTS, max_len=BLOCK_MAX_LEN,
        rt=JRt(act_dtype=jnp.float32, param_dtype=jnp.float32),
        policy=jex.parse_policy("bf16:dense:jnp"), speculative=spec, **kw)
    return port, ref


def _block_run(sess, module, arch):
    """gemma3: a prompt past the window (70 tokens, so the draft and the
    verify overwrite window rows the next steps still attend to), an
    accept-friendly repeated pair and two random prompts; MoE: lengths
    its group size of 64 takes."""
    cfg = get_reduced(arch)
    rng = np.random.default_rng(4)
    lens = (70, 40, 5) if arch == "gemma3-12b" else (64, 40, 5)
    prompts = [rng.integers(0, cfg.vocab_size, lens[0]).astype(np.int32),
               np.array([7, 11] * 4, np.int32)] \
        + [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
           for n in lens[1:]]
    for uid, p in enumerate(prompts):
        sess.submit(module.Request(uid=uid, prompt=p, max_new=12,
                                   tenant="ab"[uid % 2]))
    sess.run()
    return {r.uid: list(r.out) for r in sess.completed}


@pytest.mark.parametrize("paged", [False, True])
def test_gemma3_speculative_equals_plain_and_jax(paged):
    """The rolling windows through a k = 4 fp8 draft and its verify: the
    port commits its plain greedy stream and JAX's speculative session's,
    with JAX's acceptance totals."""
    spec = {"k": 4, "draft_policy": "fp8"}
    plain = _block_run(_block_sessions("gemma3-12b", paged, None)[0], tsl,
                       "gemma3-12b")
    port, ref = _block_sessions("gemma3-12b", paged, spec)
    got = _block_run(port, tsl, "gemma3-12b")
    want = _block_run(ref, jsl, "gemma3-12b")
    assert got == plain == want
    assert port.spec_totals == ref.spec_totals
    assert sum(t["accepted"] for t in port.spec_totals.values()) > 0


@pytest.mark.parametrize("draft", ["bf16:dense", "fp8:sparse24"])
@pytest.mark.parametrize("paged", [False, True])
def test_moe_speculative_equals_jax(paged, draft):
    """granite: expert capacity couples a step's slots, so a rejected
    draft of one slot can change another slot's routing in the verify and
    the committed stream need not be plain greedy's, in the reference as
    in the port; the gate is JAX's speculative session (its
    ``multi_decode_step``): the same tokens and acceptance totals. A bf16
    draft is the verify's own computation (every draft accepted, plain
    greedy's stream); the fp8:sparse24 draft is rejected often, and here
    the stream parts from plain greedy's in both packages. (With the fp8
    draft the two packages' drafts part at some draft step, which this
    test does not trace, so their acceptance differs.)"""
    spec = {"k": 4, "draft_policy": draft}
    port, ref = _block_sessions("granite-moe-3b-a800m", paged, spec)
    got = _block_run(port, tsl, "granite-moe-3b-a800m")
    want = _block_run(ref, jsl, "granite-moe-3b-a800m")
    assert got == want
    assert port.spec_totals == ref.spec_totals
    plain = _block_run(_block_sessions("granite-moe-3b-a800m", paged,
                                       None)[0], tsl, "granite-moe-3b-a800m")
    assert (got == plain) == (draft == "bf16:dense")


@pytest.mark.parametrize("n_acc", [0, 2])
@pytest.mark.parametrize("paged", [False, True])
def test_window_after_the_draft_and_verify_equals_plain_decode(paged, n_acc):
    """gemma3 with a 70-token prompt (its windows of 64 rolled): the fp8
    draft overwrites window rows in place and puts them back; a k = 4
    verify whose drafts match plain greedy for ``n_acc`` steps must leave
    every leaf, windows included, bit-equal to ``n_acc + 1`` plain decode
    steps (the reference's snapshot at step ``n_acc``); and from JAX's own
    cache, bridged, the port's rolled-back windows equal JAX's
    ``multi_decode_step``'s bit for bit except in the rows the accepted
    steps wrote (within one bf16 ulp there)."""
    from repro.models import transformer as jtf
    k = 4
    cfg = get_reduced("gemma3-12b")
    port, ref = _block_sessions("gemma3-12b", paged, None)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, 70) \
        .astype(np.int32)
    port.admit(tsl.Request(uid=0, prompt=prompt, max_new=32))
    ref.admit(jsl.Request(uid=0, prompt=prompt, max_new=32))
    for _ in range(2):
        port.decode_once()
        ref.decode_once()
    pos = torch.as_tensor(port.slot_pos.astype(np.int64))
    if paged:
        port.pager.extend_slot(0, int(pos[0]) + k)
        port._sync_page_map()
    pm = (port._page_map,) if paged else ()
    step = tt.paged_decode_step if paged else tt.decode_step
    plain = _clone(port.caches)
    tok, greedy = port.tokens, []
    for j in range(n_acc + 1):
        logits, _ = step(port.params, tok, plain, pos + j, *pm, port.cfg,
                         port.rt)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        greedy.append(int(tok[0, 0]))
    draft = tspv.make_draft_step(port.cfg, port.rt, tex.parse_policy("fp8"),
                                 k - 1, paged=paged)
    before = _clone(port.caches)
    draft(port.params, port.tokens, port.caches, pos, *pm)
    win = [i for i, kind in enumerate(tt.layer_kinds(cfg))
           if kind == "attn_local"]
    assert all(torch.equal(port.caches[i][key], before[i][key])
               for i in win for key in ("k", "v", "pos"))
    bad = (greedy[-1] + 1) % cfg.vocab_size
    seq = [int(port.tokens[0, 0])] + greedy[:n_acc] + [bad] * (k - 1 - n_acc)
    seq2 = torch.tensor([seq, [int(port.tokens[1, 0])] + [0] * (k - 1)],
                        dtype=torch.int32)
    active = torch.tensor([True, False])
    multi = tt.paged_multi_decode_step if paged else tt.multi_decode_step
    _, g, acc, rolled = multi(port.params, seq2, port.caches, pos, active,
                              *pm, port.cfg, port.rt)
    assert int(acc[0]) == n_acc and g[0, :n_acc + 1].tolist() == greedy
    # the active slot's rows (slot 0 of each slot-indexed leaf, the pool's
    # pages but the trash page): the idle slot keeps one write per verify
    # where plain steps would write it n_acc + 1 times
    pooled = [paged and kind in tt.PAGED_KINDS for kind in tt.layer_kinds(cfg)]
    assert all(torch.equal(_bits(x[key][:-1] if pool else x[key][0]),
                           _bits(y[key][:-1] if pool else y[key][0]))
               for x, y, pool in zip(rolled, plain, pooled)
               for key in ("k", "v", "pos"))
    if paged:
        return
    # JAX's verify on its own cache, and the port's on that cache bridged:
    # positions equal, every row the rollback kept or put back bit-equal,
    # the accepted steps' new rows within one bf16 ulp (each package
    # computes its own K/V projections)
    jpos = jnp.asarray(ref.slot_pos)
    from_jax = bridge.caches_from_numpy(jax.tree.map(np.asarray, ref.caches),
                                        cfg)
    _, _, jacc, jc = jtf.multi_decode_step(
        ref.params, jnp.asarray(seq2.numpy()), ref.caches, jpos,
        jnp.asarray([True, False]), cfg, ref.rt)
    _, _, acc2, rolled2 = tt.multi_decode_step(
        port.params, seq2, from_jax, torch.as_tensor(np.array(jpos)).long(),
        active, cfg, port.rt)
    assert int(jacc[0]) == int(acc2[0]) == n_acc
    jl = bridge.caches_from_numpy(jax.tree.map(np.asarray, jc), cfg)
    w = cfg.window_size
    written = np.zeros((2, w), bool)
    written[0, [(int(jpos[0]) + j) % w for j in range(n_acc + 1)]] = True
    written[1, int(jpos[1]) % w] = True
    for i in win:
        np.testing.assert_array_equal(rolled2[i]["pos"].numpy(),
                                      jl[i]["pos"].numpy())
        for key in ("k", "v"):
            got, want = rolled2[i][key], jl[i][key]
            assert torch.equal(_bits(got[~torch.from_numpy(written)]),
                               _bits(want[~torch.from_numpy(written)]))
            np.testing.assert_allclose(got.float().numpy(),
                                       want.float().numpy(), rtol=2 ** -7,
                                       atol=0)


# ---------------------------------------------------------------------------
# The recurrent stacks
# ---------------------------------------------------------------------------

RECURRENT = ["rwkv6-3b", "zamba2-1.2b"]


def _recurrent_run(sess, module, arch):
    """A prompt of one chunk (32), an accept-friendly repeated pair and two
    short random prompts, through two slots."""
    cfg = get_reduced(arch)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, 32).astype(np.int32),
               np.array([7, 11] * 4, np.int32)] \
        + [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
           for n in (5, 8)]
    for uid, p in enumerate(prompts):
        sess.submit(module.Request(uid=uid, prompt=p, max_new=12,
                                   tenant="ab"[uid % 2]))
    sess.run()
    return {r.uid: list(r.out) for r in sess.completed}


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_speculative_equals_plain_and_jax(arch, paged):
    """A k = 4 fp8 draft over the recurrent states: the port commits its
    plain greedy stream and JAX's speculative session's, with JAX's
    acceptance totals; some drafts are rejected, so the verify's state
    rollback ran."""
    spec = {"k": 4, "draft_policy": "fp8"}
    plain = _recurrent_run(_block_sessions(arch, paged, None)[0], tsl, arch)
    port, ref = _block_sessions(arch, paged, spec)
    got = _recurrent_run(port, tsl, arch)
    want = _recurrent_run(ref, jsl, arch)
    assert got == plain == want
    assert port.spec_totals == ref.spec_totals
    acc = sum(t["accepted"] for t in port.spec_totals.values())
    assert 0 < acc < sum(t["drafted"] for t in port.spec_totals.values())


def _recurrent_prefilled(arch, paged):
    """The port's and JAX's f32 sessions with one 32-token request in slot
    0 after two plain steps; slot 1 idle."""
    cfg = get_reduced(arch)
    port, ref = _block_sessions(arch, paged, None)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, 32) \
        .astype(np.int32)
    port.admit(tsl.Request(uid=0, prompt=prompt, max_new=32))
    ref.admit(jsl.Request(uid=0, prompt=prompt, max_new=32))
    for _ in range(2):
        port.decode_once()
        ref.decode_once()
    return cfg, port, ref


def _state_leaves(caches, cfg):
    return [(li, key, c[key]) for li, (kind, c) in enumerate(
        zip(tt.layer_kinds(cfg), caches)) if kind in tt.STATE_KINDS
        for key in c]


@pytest.mark.parametrize("arch", RECURRENT)
def test_draft_leaves_no_recurrent_state_written(arch):
    """The draft's steps replace every state leaf; when its chain ends the
    session's cache holds the very tensors it started from, unchanged."""
    k = 4
    cfg, port, _ = _recurrent_prefilled(arch, False)
    pos = torch.as_tensor(port.slot_pos.astype(np.int64))
    before = _state_leaves(port.caches, cfg)
    saved = [t.clone() for _, _, t in before]
    draft = tspv.make_draft_step(port.cfg, port.rt, tex.parse_policy("fp8"),
                                 k - 1)
    seq = draft(port.params, port.tokens, port.caches, pos)
    assert seq.shape == (SLOTS, k)
    after = _state_leaves(port.caches, cfg)
    assert len(after) == len(before) > 0
    for (li, key, t), (_, _, t0), old in zip(after, before, saved):
        assert t is t0, (li, key)
        assert torch.equal(_bits(t), _bits(old)), (li, key)


@pytest.mark.parametrize("n_acc", [0, 2])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_state_after_the_draft_and_verify_equals_plain_decode(
        arch, paged, n_acc):
    """The fp8 draft, then a k = 4 verify whose drafts match plain greedy
    for ``n_acc`` steps: slot 0's every leaf (state leaves, and the shared
    attention's rows or pages) bit-equal to ``n_acc + 1`` plain decode
    steps, the reference's snapshot at step ``n_acc``; and, dense, from
    JAX's own cache, bridged, the port's rolled-back states within 1e-4 of
    JAX's ``multi_decode_step``'s."""
    from repro.models import transformer as jtf
    k = 4
    cfg, port, ref = _recurrent_prefilled(arch, paged)
    pos = torch.as_tensor(port.slot_pos.astype(np.int64))
    if paged:
        port.pager.extend_slot(0, int(pos[0]) + k)
        port._sync_page_map()
    pm = (port._page_map,) if paged else ()
    step = tt.paged_decode_step if paged else tt.decode_step
    plain = _clone(port.caches)
    tok, greedy = port.tokens, []
    for j in range(n_acc + 1):
        logits, _ = step(port.params, tok, plain, pos + j, *pm, port.cfg,
                         port.rt)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        greedy.append(int(tok[0, 0]))
    draft = tspv.make_draft_step(port.cfg, port.rt, tex.parse_policy("fp8"),
                                 k - 1, paged=paged)
    draft(port.params, port.tokens, port.caches, pos, *pm)
    bad = (greedy[-1] + 1) % cfg.vocab_size
    seq = [int(port.tokens[0, 0])] + greedy[:n_acc] + [bad] * (k - 1 - n_acc)
    seq2 = torch.tensor([seq, [int(port.tokens[1, 0])] + [0] * (k - 1)],
                        dtype=torch.int32)
    active = torch.tensor([True, False])
    multi = tt.paged_multi_decode_step if paged else tt.multi_decode_step
    _, g, acc, rolled = multi(port.params, seq2, port.caches, pos, active,
                              *pm, port.cfg, port.rt)
    assert int(acc[0]) == n_acc and g[0, :n_acc + 1].tolist() == greedy
    pooled = [paged and kind in tt.PAGED_KINDS for kind in tt.layer_kinds(cfg)]
    assert all(torch.equal(_bits(x[key][:-1] if pool else x[key][0]),
                           _bits(y[key][:-1] if pool else y[key][0]))
               for x, y, pool in zip(rolled, plain, pooled) for key in x)
    if paged:
        return
    from_jax = bridge.caches_from_numpy(jax.tree.map(np.asarray, ref.caches),
                                        cfg)
    jpos = jnp.asarray(ref.slot_pos)
    _, _, jacc, jc = jtf.multi_decode_step(
        ref.params, jnp.asarray(seq2.numpy()), ref.caches, jpos,
        jnp.asarray([True, False]), cfg, ref.rt)
    _, _, acc2, rolled2 = tt.multi_decode_step(
        port.params, seq2, from_jax, torch.as_tensor(np.array(jpos)).long(),
        active, cfg, port.rt)
    assert int(jacc[0]) == int(acc2[0]) == n_acc
    jl = bridge.caches_from_numpy(jax.tree.map(np.asarray, jc), cfg)
    for li, key, t in _state_leaves(rolled2, cfg):
        np.testing.assert_allclose(t.float().numpy(),
                                   jl[li][key].float().numpy(), rtol=1e-4,
                                   atol=1e-4)
