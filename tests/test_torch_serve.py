"""Greedy tokens of the port's ServeSession against the JAX ServeSession.

Both sessions serve 4 requests through 2 slots from the same JAX init
(bridged bit for bit). In f32 the tokens must be equal. In bf16 the two
stacks round differently (XLA keeps excess precision inside fusions,
PyTorch rounds after every op; see test_torch_transformer.py), so a token
may flip where the top two logits are closer than twice the logit
tolerance: the test asserts that every request's tokens are equal up to its
first flip and that the flip happened at such a near-tie.
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
from repro.models import init_params
from repro.models.layers import RuntimeCfg as JRt
from repro.runtime import serve_loop as jsl
from repro_torch import bridge
from repro_torch.core import execution as tex
from repro_torch.models.layers import RuntimeCfg as TRt
from repro_torch.runtime import serve_loop as tsl

CFG = get_reduced("llama3-8b")
PROMPT_LENS = (5, 8, 5, 8)
MAX_NEW, MAX_LEN, SLOTS = 6, 32, 2
# twice the per-logit tolerance of test_torch_transformer.py's bf16 test
NEAR_TIE = {"bf16": 2 * 3e-2, "fp8": 2 * 0.25}


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, CFG.vocab_size, size=(n,)).astype(np.int32)
            for n in PROMPT_LENS]


def _margin(logits_row: torch.Tensor) -> float:
    top = torch.topk(logits_row.float(), 2).values
    return float(top[0] - top[1])


def _run_port(sess):
    """ServeSession.run, one step at a time, keeping the top-2 margin of
    the logits behind every token: {(uid, index): margin}."""
    margins = {}
    while sess.queue or sess.n_active:
        while sess.queue and sess.can_admit(sess.queue[0]):
            req = sess.queue.pop(0)
            sess.admit(req)
            margins[(req.uid, 0)] = _margin(sess.last_logits[0])
        active = [(i, r, len(r.out)) for i, r in enumerate(sess.slots)
                  if r is not None]
        sess.decode_once()
        for i, r, n in active:
            margins[(r.uid, n)] = _margin(sess.last_logits[i])
    return {r.uid: r.out for r in sess.completed}, margins


def _serve_both(jspec, tspec, use_pallas, dtype, **session_kw):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" \
        else (jnp.bfloat16, torch.bfloat16)
    params = init_params(jax.random.PRNGKey(0), CFG, dtype=jdt)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params), CFG)
    jsess = jsl.ServeSession(
        params, CFG, batch_slots=SLOTS, max_len=MAX_LEN,
        rt=JRt(act_dtype=jdt, param_dtype=jdt, use_pallas=use_pallas),
        policy=jex.parse_policy(jspec), **session_kw)
    tsess = tsl.ServeSession(
        tparams, CFG, batch_slots=SLOTS, max_len=MAX_LEN,
        rt=TRt(act_dtype=tdt, use_pallas=use_pallas),
        policy=tex.parse_policy(tspec), device="cpu", **session_kw)
    for uid, prompt in enumerate(_prompts()):
        jsess.submit(jsl.Request(uid=uid, prompt=prompt, max_new=MAX_NEW))
        tsess.submit(tsl.Request(uid=uid, prompt=prompt, max_new=MAX_NEW))
    want = {r.uid: r.out for r in jsess.run()}
    got, margins = _run_port(tsess)
    return want, got, margins


def check_tokens(jspec, tspec, use_pallas, dtype, **session_kw):
    """``session_kw`` (e.g. ``paged=True``) goes to both sessions."""
    want, got, margins = _serve_both(jspec, tspec, use_pallas, dtype,
                                     **session_kw)
    assert sorted(got) == sorted(want) == list(range(len(PROMPT_LENS)))
    for uid in want:
        assert len(got[uid]) == len(want[uid]) == MAX_NEW
        if dtype == "f32":
            assert got[uid] == want[uid], uid
            continue
        flip = next((i for i, (a, b) in enumerate(zip(got[uid], want[uid]))
                     if a != b), None)
        if flip is not None:
            near = NEAR_TIE[jspec.split(":")[0]]
            assert margins[(uid, flip)] < near, (uid, flip, margins)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("jspec,tspec,use_pallas", [
    ("bf16:dense:jnp", "bf16:dense:torch", False),
    ("bf16:dense:pallas", "bf16:dense:hopper", True),
])
def test_greedy_tokens_match_jax(jspec, tspec, use_pallas, dtype):
    check_tokens(jspec, tspec, use_pallas, dtype)


def test_session_needs_a_device_on_a_cpu_only_machine():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the session defaults to it")
    tparams = {"embed": torch.zeros(1)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsl.ServeSession(tparams, CFG, batch_slots=1, max_len=8)


def test_unported_session_modes_raise():
    """Sampling is not ported (the policy resolver is:
    test_torch_runtime_policy.py; the paged cache and the slot handoff:
    test_torch_serve_paged.py; speculation: test_torch_speculative.py)."""
    with pytest.raises(NotImplementedError):
        tsl.ServeSession({}, CFG, batch_slots=1, max_len=8, device="cpu",
                         temperature=0.7)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, repro_torch.runtime.serve_loop, "
            "repro_torch.launch.serve, repro_torch.kernels.ops, "
            "repro_torch.bridge, repro_torch.core.sparsity, "
            "repro_torch.kernels.sparse24_matmul, repro_torch.core.paging, "
            "repro_torch.kernels.paged_attention, "
            "repro_torch.core.speculative, repro_torch.core.concurrency, "
            "repro_torch.core.execution, repro_torch.kernels.registry, "
            "repro_torch.runtime.telemetry, repro_torch.runtime.scheduler, "
            "repro_torch.runtime.metrics, repro_torch.runtime.controller, "
            "repro_torch.runtime.server, repro_torch.runtime.partition, "
            "repro_torch.runtime.traceview, repro_torch.runtime.workload, "
            "repro_torch.launch.loadgen\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(','.join(bad))")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120, env=env)
    assert out.stdout.strip() == "", out.stdout
