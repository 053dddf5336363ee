"""Shared set-up of the port's training parity tests (not a test module).

Reduced llama3-8b (or another reduced arch), one JAX init bridged bit for
bit to the port, the same ``SyntheticLM`` batches (numpy, so bit-equal in
both packages), and a few train steps of JAX's ``make_train_step`` (jitted
once per case) beside the port's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core import execution as jex
from repro.data.pipeline import SyntheticLM
from repro.models import init_params
from repro.models.layers import RuntimeCfg as JRt
from repro.optim import adamw as jadam
from repro.runtime import train_loop as jtl
from repro_torch import bridge
from repro_torch.core import execution as tex
from repro_torch.models.layers import RuntimeCfg as TRt
from repro_torch.optim import adamw as tadam
from repro_torch.runtime import train_loop as ttl

B, S, STEPS = 4, 32, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small shapes (as fast alone): the
    suite runs several worker processes on the machine's cores, and
    torch's default pool of one thread per core in each of them
    oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# losses: f32 differs only in the order of f32 sums; bf16 at the JAX
# package's own tolerance (test_microbatch_matches_full_batch)
LOSS_TOL = {"f32": 1e-5, "bf16": 2e-2}


def opt_cfgs():
    kw = dict(total_steps=10, warmup_steps=2)
    return jadam.AdamWConfig(**kw), tadam.AdamWConfig(**kw)


def rts(dtype: str, use_pallas: bool = False):
    jd, td = DTYPES[dtype]
    return (JRt(chunk_q=32, chunk_kv=32, ssm_chunk=16, act_dtype=jd,
                param_dtype=jd, use_pallas=use_pallas),
            TRt(chunk_q=32, chunk_kv=32, ssm_chunk=16, act_dtype=td,
                param_dtype=td, use_pallas=use_pallas))


def batches(cfg, n=STEPS, b=B, s=S):
    data = SyntheticLM(cfg.vocab_size, s, b, seed=0)
    return [data.batch_at(i) for i in range(n)]


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def as_f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@functools.lru_cache(maxsize=None)
def jax_run(arch, dtype, jspec, grad_compress="none", microbatch=0,
            steps=STEPS):
    """JAX's run: (the initial state with numpy leaves, [(metrics as
    floats, state with numpy leaves) after each step])."""
    cfg = get_reduced(arch)
    jopt, _ = opt_cfgs()
    jrt, _ = rts(dtype)
    params = init_params(jax.random.PRNGKey(0), cfg, dtype=DTYPES[dtype][0])
    state = jtl.init_state(params, jopt, grad_compress)
    init = jax.tree.map(np.asarray, state)
    step = jax.jit(jtl.make_train_step(
        cfg, jopt, jrt, grad_compress=grad_compress, microbatch=microbatch,
        policy=jex.parse_policy(jspec)))
    out = []
    for batch in batches(cfg, steps):
        state, metrics = step(state, to_jax(batch))
        out.append(({k: float(v) for k, v in metrics.items()},
                    jax.tree.map(np.asarray, state)))
    return init, out


def torch_step(arch, dtype, tspec, grad_compress="none", microbatch=0,
               use_pallas=False):
    cfg = get_reduced(arch)
    _, topt = opt_cfgs()
    _, trt = rts(dtype, use_pallas)
    return ttl.make_train_step(cfg, topt, trt, grad_compress=grad_compress,
                               microbatch=microbatch,
                               policy=tex.parse_policy(tspec))


def torch_run(arch, dtype, tspec, init, grad_compress="none", microbatch=0,
              steps=STEPS):
    """The port's run from the bridged JAX ``init``: [(metrics as floats,
    state)]."""
    cfg = get_reduced(arch)
    state = bridge.train_state_from_numpy(init, cfg)
    step = torch_step(arch, dtype, tspec, grad_compress, microbatch)
    out = []
    for batch in batches(cfg, steps):
        state, metrics = step(state, to_torch(batch))
        out.append(({k: float(v) for k, v in metrics.items()}, state))
    return out


def state_gaps(cfg, tstate, jstate):
    """Largest |port - JAX| per part of the state (params, mu, nu,
    master), over every leaf, in f32."""
    gaps = {}
    for name, t, j in (("params", tstate.params, jstate.params),
                       ("mu", tstate.opt.mu, jstate.opt.mu),
                       ("nu", tstate.opt.nu, jstate.opt.nu),
                       ("master", tstate.opt.master, jstate.opt.master)):
        tl = jax.tree.leaves(bridge.params_to_numpy(t, cfg))
        jl = jax.tree.leaves(as_f32(j))
        assert len(tl) == len(jl)
        gaps[name] = max(float(np.max(np.abs(a - b))) for a, b in zip(tl, jl))
    return gaps
