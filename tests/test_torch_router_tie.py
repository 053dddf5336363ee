"""Reduced llama4-scout-17b-a16e in bf16: where the port's greedy tokens
part from JAX's, and why.

Both packages serve the same two requests from one bridged bf16 init
(top-1 routing over 4 experts, capacity 1 per expert at decode, 2 MoE
layers). Every MoE call's input and router logits are recorded in both.
The first call whose expert choice or capacity cut differs must be a
router near-tie that one bf16 ulp of the router's input can swap:

* every earlier MoE call routes every token identically;
* the port's router on JAX's own input routes as JAX does (the router
  agrees given the same input; the inputs differ by the bf16 roundings of
  the sublayers before it, which XLA's fusions skip and PyTorch makes);
* at each token whose choice differs, the gap between JAX's top-2 router
  logits is smaller than the most a one-ulp move of each bf16 input
  element can change it (sum of ulp(x_i) · |W_i,a − W_i,b|);
* no greedy token differs before that decode step.

This is the documented deviation of ROADMAP §3 (the margin-0.31 token
flip that keeps the arch out of the bf16 serving test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import execution as jex
from repro.models import init_params
from repro.models import moe as jmoe
from repro.models.layers import RuntimeCfg as JRt
from repro.runtime import serve_loop as jsl
from repro_torch import bridge
from repro_torch.core import execution as tex
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import RuntimeCfg as TRt
from repro_torch.runtime import serve_loop as tsl

from torch_train_parity import one_torch_thread  # noqa: F401 (a fixture)

ARCH = "llama4-scout-17b-a16e"
PROMPT_LENS, MAX_NEW, MAX_LEN, SLOTS = (5, 40), 5, 96, 2


@pytest.fixture
def recorded(monkeypatch):
    """(JAX calls, port calls): each MoE call's input ``x``, router
    logits, capacity and (port) router weight, in call order."""
    jcalls, tcalls = [], []
    j_mlp, j_rd = jmoe.moe_mlp, jmoe.router_dispatch
    t_mlp, t_rd = tmoe.moe_mlp, tmoe.router_dispatch

    def jax_mlp(h, p, cfg, rt=jmoe.DEFAULT_RT):
        jax.debug.callback(lambda a: jcalls.append({"x": np.asarray(a)}), h,
                           ordered=True)
        return j_mlp(h, p, cfg, rt)

    def jax_rd(logits, cfg, cap):
        jax.debug.callback(
            lambda a: jcalls[-1].update(logits=np.asarray(a), cap=cap),
            logits, ordered=True)
        return j_rd(logits, cfg, cap)

    def port_mlp(h, p, cfg, rt=tmoe.DEFAULT_RT):
        tcalls.append({"x": h.float().numpy().copy(),
                       "router": p["router"].float().numpy().copy()})
        return t_mlp(h, p, cfg, rt)

    def port_rd(logits, cfg, cap):
        tcalls[-1].update(logits=logits.numpy().copy(), cap=cap)
        return t_rd(logits, cfg, cap)

    monkeypatch.setattr(jmoe, "moe_mlp", jax_mlp)
    monkeypatch.setattr(jmoe, "router_dispatch", jax_rd)
    monkeypatch.setattr(tmoe, "moe_mlp", port_mlp)
    monkeypatch.setattr(tmoe, "router_dispatch", port_rd)
    jsl.clear_jit_cache()          # trace the steps with the hooks
    yield jcalls, tcalls
    jsl.clear_jit_cache()          # and leave no hooked step behind


def _serve():
    cfg = get_reduced(ARCH)
    params = init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    jsess = jsl.ServeSession(
        params, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
        rt=JRt(act_dtype=jnp.bfloat16, param_dtype=jnp.bfloat16,
               use_pallas=True),
        policy=jex.parse_policy("bf16:dense:pallas"))
    tsess = tsl.ServeSession(
        tparams, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
        rt=TRt(act_dtype=torch.bfloat16, use_pallas=True),
        policy=tex.parse_policy("bf16:dense:hopper"), device="cpu")
    rng = np.random.default_rng(0)
    for uid, n in enumerate(PROMPT_LENS):
        prompt = rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
        jsess.submit(jsl.Request(uid=uid, prompt=prompt, max_new=MAX_NEW))
        tsess.submit(tsl.Request(uid=uid, prompt=prompt, max_new=MAX_NEW))
    want = {r.uid: r.out for r in jsess.run()}
    jax.effects_barrier()
    got = {r.uid: r.out for r in tsess.run()}
    return want, got


def _route(logits, cap):
    """Top-1 expert of every token and whether it fits its expert's
    capacity (tokens in order), as both packages' routers decide."""
    top = logits.argmax(-1)
    keep = np.zeros(top.shape, dtype=bool)
    for g in range(top.shape[0]):
        used = {}
        for s in range(top.shape[1]):
            e = int(top[g, s])
            keep[g, s] = used.get(e, 0) < cap
            used[e] = used.get(e, 0) + 1
    return top, keep


def _one_ulp_reach(x, w, a, b):
    """The most a move of one bf16 ulp in every element of ``x`` can
    change the router logit gap between experts ``a`` and ``b``."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)
    return float((ulp * np.abs(w[:, a] - w[:, b])).sum())


def test_llama4_bf16_divergence_is_a_router_tie_within_one_bf16_ulp(
        recorded):
    jcalls, tcalls = recorded
    want, got = _serve()
    # two MoE layers: one call each per prefill and per decode step
    n_layers = 2
    prefill_calls = n_layers * len(PROMPT_LENS)
    assert len(jcalls) == len(tcalls) == prefill_calls \
        + n_layers * (MAX_NEW - 1)
    first = None
    for i, (j, t) in enumerate(zip(jcalls, tcalls)):
        jr, tr = _route(j["logits"], j["cap"]), _route(t["logits"], t["cap"])
        if not (np.array_equal(jr[0], tr[0])
                and np.array_equal(jr[1], tr[1])):
            first = i
            break
    if first is None:
        assert got == want
        return
    j, t = jcalls[first], tcalls[first]
    d = j["x"].shape[-1]
    x = j["x"].astype(np.float32).reshape(-1, d)
    lj = j["logits"].reshape(-1, j["logits"].shape[-1])
    # the port's router, given JAX's input, routes as JAX
    teacher = (x @ t["router"]).reshape(j["logits"].shape)
    assert np.array_equal(_route(teacher, j["cap"])[0],
                          _route(j["logits"], j["cap"])[0])
    # each token that routes differently sits within one ulp of a tie
    jtop = _route(j["logits"], j["cap"])[0].reshape(-1)
    ttop = _route(t["logits"], t["cap"])[0].reshape(-1)
    flips = np.nonzero(jtop != ttop)[0]
    assert flips.size
    for k in flips:
        a, b = int(jtop[k]), int(ttop[k])
        gap = float(lj[k, a] - lj[k, b])
        assert 0 <= gap < _one_ulp_reach(x[k], t["router"], a, b), (k, gap)
    # no greedy token differs before that decode step
    step = (first - prefill_calls) // n_layers
    assert first >= prefill_calls and step >= 0
    for uid in want:
        assert got[uid][:step + 1] == want[uid][:step + 1], (uid, step)
