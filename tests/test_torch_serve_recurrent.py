"""The recurrent block kinds through serving, against the JAX package:
rwkv6-3b (rwkv6 only) and zamba2-1.2b (mamba2, the shared attention
block and the hybrid tail), reduced (chunk 32).

Both packages run from the same JAX init, bridged bit for bit. In f32 the
logits and the state leaves agree within 1e-4 (the reference's own SSM
tolerance, tests/test_ssm_blocks.py), dense and paged, and the greedy
tokens are equal; in bf16 a token may flip only at a near-tie
(test_torch_serve.py). The slot operations (admission, export/import,
free) move the state leaves whole, as the reference's do, including its
two quirks at short prompts: a 1-token prompt's one conv row is broadcast
over the slot's three, and a 2-token prompt is refused; a prompt longer
than the chunk and no multiple of it is refused by the prefill.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import execution as jex
from repro.core import paging as jpaging
from repro.models import init_params
from repro.models.layers import RuntimeCfg as JRt
from repro.runtime import serve_loop as jsl
from repro_torch import bridge
from repro_torch.core import execution as tex
from repro_torch.core import paging as tpaging
from repro_torch.models import transformer as tt
from repro_torch.models.layers import RuntimeCfg as TRt
from repro_torch.runtime import serve_loop as tsl
from test_torch_serve import NEAR_TIE, _run_port

ARCHS = ["rwkv6-3b", "zamba2-1.2b"]
MAX_LEN, SLOTS, PAGE, STEPS = 96, 2, 16, 4
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = dict(rtol=1e-4, atol=1e-4)
_PARAMS = {}


def _params(arch, dtype="f32"):
    if (arch, dtype) not in _PARAMS:
        cfg = get_reduced(arch)
        params = init_params(jax.random.PRNGKey(0), cfg,
                             dtype=DTYPES[dtype][0])
        _PARAMS[arch, dtype] = (params, bridge.params_from_numpy(
            jax.tree.map(np.asarray, params), cfg))
    return _PARAMS[arch, dtype]


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(n,)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)


# ---------------------------------------------------------------------------
# ServeSession
# ---------------------------------------------------------------------------

# a prompt of two chunks, one token (its conv row broadcast), and others
# shorter than one chunk, through two slots
SESSION_LENS = (64, 1, 5, 32, 8)


def _sessions(arch, dtype, paged, **kw):
    cfg = get_reduced(arch)
    jdt, tdt = DTYPES[dtype]
    params, tparams = _params(arch, dtype)
    if paged:
        kw.update(paged=True, page_size=PAGE)
    jsess = jsl.ServeSession(
        params, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
        rt=JRt(act_dtype=jdt, param_dtype=jdt),
        policy=jex.parse_policy("bf16:dense:jnp"), **kw)
    tsess = tsl.ServeSession(
        tparams, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
        rt=TRt(act_dtype=tdt), policy=tex.parse_policy("bf16:dense:torch"),
        device="cpu", **kw)
    return cfg, jsess, tsess


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax(arch, dtype, paged):
    """Five requests through two slots: equal tokens in f32; in bf16 equal
    up to a first flip at a near-tie."""
    cfg, jsess, tsess = _sessions(arch, dtype, paged)
    for uid, n in enumerate(SESSION_LENS):
        p = _prompt(cfg, n, 10 + uid)
        jsess.submit(jsl.Request(uid=uid, prompt=p, max_new=6))
        tsess.submit(tsl.Request(uid=uid, prompt=p, max_new=6))
    want = {r.uid: r.out for r in jsess.run()}
    got, margins = _run_port(tsess)
    assert sorted(got) == sorted(want) == list(range(len(SESSION_LENS)))
    for uid in want:
        assert len(got[uid]) == len(want[uid]) == 6
        if dtype == "f32":
            assert got[uid] == want[uid], uid
            continue
        flip = next((i for i, (a, b) in enumerate(zip(got[uid], want[uid]))
                     if a != b), None)
        if flip is not None:
            assert margins[(uid, flip)] < NEAR_TIE["bf16"], (uid, flip)


def _session_caches(sess, cfg):
    """A JAX session's cache in the port's per-layer layout."""
    return bridge.caches_from_numpy(jax.tree.map(np.asarray, sess.caches),
                                    cfg)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_export_import_and_free_match_jax(arch, paged):
    """f32, one request exported after two decode steps: the export holds
    the same leaves as JAX's (each state leaf the slot's whole row; the
    shared attention's pages or rows), within 1e-4; the exporting slot is
    left as JAX leaves it (states zeroed, pages scrubbed); the import
    resumes with the uninterrupted run's tokens in both packages; and a
    freed slot is zeroed as in JAX."""
    cfg, jsrc, tsrc = _sessions(arch, "f32", paged)
    prompt = _prompt(cfg, 32, 3)
    plain = _sessions(arch, "f32", paged)[2]
    plain.submit(tsl.Request(uid=0, prompt=prompt, max_new=8))
    want = plain.run()[0].out
    for sess, mod in ((jsrc, jsl), (tsrc, tsl)):
        sess.admit(mod.Request(uid=0, prompt=prompt, max_new=8))
        sess.admit(mod.Request(uid=1, prompt=_prompt(cfg, 5, 4), max_new=8))
        sess.decode_once()
        sess.decode_once()
    jexp, texp = jsrc.export_slot(0), tsrc.export_slot(0)
    assert (texp.pos, texp.token, texp.pages) == \
        (jexp.pos, jexp.token, jexp.pages)
    jstate = bridge.caches_from_numpy(jax.tree.map(np.asarray, jexp.caches),
                                      cfg)
    for t, j, kind in zip(texp.caches, jstate, tt.layer_kinds(cfg)):
        assert sorted(t) == sorted(j)
        for key in t:
            assert t[key].shape == j[key].shape, (kind, key)
            if t[key].dtype == torch.bfloat16:
                # the session's K/V rows are bf16: the two packages' f32
                # projections may round to neighbouring bf16 values
                np.testing.assert_allclose(t[key].float().numpy(),
                                           j[key].float().numpy(),
                                           rtol=2 ** -7, atol=0)
            else:
                _close(t[key], j[key].float().numpy())
    for t, j in zip(tsrc.caches, _session_caches(jsrc, cfg)):
        for key in t:
            if key in ("k", "v", "pos") and paged:
                continue                      # pools: other slots' pages
            np.testing.assert_array_equal(t[key][0].float().numpy(),
                                          j[key][0].float().numpy())
    _, jdst, tdst = _sessions(arch, "f32", paged)
    for dst, exp in ((jdst, jexp), (tdst, texp)):
        dst.import_slot(exp)
        while dst.n_active:
            dst.decode_once()
    assert tdst.completed[0].out == jdst.completed[0].out == want
    jsrc.free_slot(1)
    tsrc.free_slot(1)
    for t, j in zip(tsrc.caches, _session_caches(jsrc, cfg)):
        for key in t:
            if key in ("k", "v", "pos") and paged:
                continue
            np.testing.assert_array_equal(t[key][1].float().numpy(),
                                          j[key][1].float().numpy())
            fill = -1 if key == "pos" else 0
            assert bool((t[key][1] == fill).all()), key


@pytest.mark.parametrize("arch", ARCHS)
def test_short_and_ragged_prompts_behave_as_in_jax(arch):
    """S = 1: both serve it (zamba2's one conv row fills the slot's three
    rows); S = 2: zamba2's conv state of two rows does not broadcast to
    three and both refuse it with a ValueError, rwkv6 serves it; S = 33:
    no multiple of the chunk of 32, both prefills raise AssertionError."""
    cfg, jsess, tsess = _sessions(arch, "f32", False)
    for n, ok in ((1, True), (2, arch == "rwkv6-3b"), (33, False)):
        p = _prompt(cfg, n, n)
        err = None if ok else (AssertionError if n == 33 else ValueError)
        outs = []
        for sess, mod in ((jsess, jsl), (tsess, tsl)):
            req = mod.Request(uid=n, prompt=p, max_new=4)
            if err is None:
                slot = sess.admit(req)
                while sess.slots[slot] is not None:
                    sess.decode_once()
                outs.append(req.out)
            else:
                with pytest.raises(err):
                    sess.admit(req)
                sess.slots = [None] * SLOTS
        if ok:
            assert outs[0] == outs[1], n
    if arch == "zamba2-1.2b":
        _, _, fresh = _sessions(arch, "f32", False)
        fresh.admit(tsl.Request(uid=0, prompt=_prompt(cfg, 1, 1),
                                max_new=4))
        conv = [c["conv"][0] for kind, c in zip(tt.layer_kinds(cfg),
                                                fresh.caches)
                if kind == "mamba2"]
        assert all(torch.equal(c[0], c[1]) and torch.equal(c[1], c[2])
                   for c in conv)


def test_recurrent_kinds_are_admitted():
    for arch in ARCHS:
        cfg = get_reduced(arch)
        tt.check_supported(cfg)
        assert tpaging.state_block_tokens(cfg) == \
            jpaging.state_block_tokens(cfg) > 0
    kinds = tt.layer_kinds(get_reduced("zamba2-1.2b"))
    assert kinds == ["mamba2", "mamba2", "shared_attn"] * 2 + ["mamba2"]


@pytest.mark.parametrize("speculative", [None, {
    "k": 3, "draft_policy": "fp8:dense:torch"}], ids=["plain", "spec"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_marks_the_state_leaves_in_use_on_its_lanes(
        arch, speculative, monkeypatch):
    """A decode step replaces each state leaf as it is enqueued, so the
    leaves it starts from lose their last reference before the lane has
    read them: ``dispatch_decode`` marks every one in use on each lane
    that reads it (the session's lane; a speculative step's draft lane
    too), as it marks the tokens, so that on the card the allocator keeps
    their blocks until those lanes are done."""
    cfg = get_reduced(arch)
    sess = tsl.ServeSession(
        _params(arch)[1], cfg, batch_slots=SLOTS, max_len=MAX_LEN,
        policy=tex.parse_policy("bf16:dense:torch"), device="cpu",
        speculative=speculative)
    for uid in range(SLOTS):
        sess.admit(tsl.Request(uid=uid, prompt=_prompt(cfg, 8, uid),
                               max_new=6))
    marked = []
    monkeypatch.setattr(tsl, "_in_use_on", lambda lane, *ts: marked.append(
        (lane.name, {id(t) for t in ts})))
    for _ in range(2):
        leaves = {id(t) for c in tt.state_layers(sess.caches, cfg)
                  for t in c.values()}
        assert leaves
        marked.clear()
        sess.join_decode(sess.dispatch_decode())
        assert {name for name, ids in marked if leaves <= ids} == (
            {"session", "draft"} if speculative else {"session"})


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

SRC = str(Path(__file__).resolve().parents[1] / "src")


@pytest.mark.parametrize("extra", [(), ("--paged", "--pages", "24")])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_completes_the_recurrent_archs(arch, extra):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu", "--backend", "hopper",
         "--requests", "3", "--max-new", "4", *extra],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[serve] 3/3 requests" in out.stdout


@pytest.mark.parametrize("arch", ARCHS)
def test_loadgen_completes_the_recurrent_archs(arch):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.loadgen", "--arch", arch,
         "--reduced", "--device", "cpu", "--tenants", "2", "--steps", "6",
         "--partitions", "2"],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[loadgen] tokens_checksum=" in out.stdout
