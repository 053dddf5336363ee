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
# the state after three steps (params, moments, masters), largest |gap|
STATE_TOL = {"f32": 1e-4, "bf16": 2e-2}
# f32 step-0 gradients: each leaf's largest |port - JAX| over its largest
# |entry| (the orders of f32 sums differ)
GRAD_TOL = 1e-5
# the kernel-backend pair whose gradients every block kind is held to
HOPPER = ("bf16:dense:pallas", "bf16:dense:hopper")


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
    """``SyntheticLM`` batches; an embeddings-input arch (musicgen) gets
    seeded normal (b, s, d) f32 frames as inputs in place of the tokens."""
    data = SyntheticLM(cfg.vocab_size, s, b, seed=0)
    out = [data.batch_at(i) for i in range(n)]
    if cfg.input_mode == "embeddings":
        rng = np.random.default_rng(0)
        for batch in out:
            batch["inputs"] = rng.normal(size=(b, s, cfg.d_model)).astype(
                np.float32)
    return out


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


def step0_grads(arch, jspec, tspec, b=B, s=S):
    """f32 step-0 gradients of JAX's loss under ``jspec`` and the port's
    under ``tspec``, from one JAX init bridged bit for bit, on the first
    batch of ``b`` sequences of ``s``: [(the reference's leaf path, port
    f32, JAX f32)]."""
    cfg = get_reduced(arch)
    jrt, trt = rts("f32")
    jcfg, jrt = jex.apply_policy(cfg, jrt, jex.parse_policy(jspec))
    tcfg, trt = tex.apply_policy(cfg, trt, tex.parse_policy(tspec))
    params = init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    batch = batches(cfg, 1, b, s)[0]
    jg = jax.jit(jax.grad(lambda p: jtl.make_loss_fn(jcfg, jrt)(
        p, to_jax(batch))[0]))(params)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    _, tg = ttl.value_and_grad(ttl.make_loss_fn(tcfg, trt))(
        tp, to_torch(batch))
    paths = jax.tree_util.tree_flatten_with_path(as_f32(jg))[0]
    got = jax.tree.leaves(bridge.params_to_numpy(tg, cfg))
    assert len(got) == len(paths)
    return [(jax.tree_util.keystr(path), g, w)
            for (path, w), g in zip(paths, got)]


def check_step0_grads(arch, tol, jspec=HOPPER[0], tspec=HOPPER[1], b=B,
                      s=S):
    """Every leaf's f32 step-0 gradient within ``tol`` of its largest
    entry, on a batch of ``b`` sequences of ``s``."""
    for name, got, want in step0_grads(arch, jspec, tspec, b, s):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=f"{arch} {name}")


def check_three_steps(arch, dtype, jspec, tspec):
    """Three steps of each package from one init: each loss within
    LOSS_TOL, the state after them within STATE_TOL."""
    init, jout = jax_run(arch, dtype, jspec)
    tout = torch_run(arch, dtype, tspec, init)
    for (tm, _), (jm, _) in zip(tout, jout):
        assert np.isfinite(tm["loss"])
        assert abs(tm["loss"] / jm["loss"] - 1) <= LOSS_TOL[dtype], (tm, jm)
    gaps = state_gaps(get_reduced(arch), tout[-1][1], jout[-1][1])
    assert max(gaps.values()) <= STATE_TOL[dtype], gaps
    assert int(tout[-1][1].opt.step) == int(jout[-1][1].opt.step) == 3


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


def chunk_grads(port_fn, jax_fn, args, seed=0):
    """Gradients of a recurrence chunk (``args`` numpy f32, the chunk's
    outputs (y, state)) with respect to every argument, under a seeded
    random cotangent: (the port's in f32, the port's in float64, JAX's in
    f32), each a list of numpy arrays."""
    rng = np.random.default_rng(seed)

    def port(dtype):
        ts = [torch.from_numpy(a).to(dtype).requires_grad_(True)
              for a in args]
        outs = port_fn(*ts)
        gs = [torch.from_numpy(rng.normal(size=o.shape)).to(dtype)
              for o in outs]
        return [g.double().numpy() for g in torch.autograd.grad(
            sum((o * g).sum() for o, g in zip(outs, gs)), ts)]

    p32 = port(torch.float32)
    rng = np.random.default_rng(seed)
    p64 = port(torch.float64)
    rng = np.random.default_rng(seed)
    shapes = [o.shape for o in jax_fn(*map(jnp.asarray, args))]
    gs = [jnp.asarray(rng.normal(size=s).astype(np.float32)) for s in shapes]
    jg = jax.grad(lambda *a: sum(jnp.sum(o * g) for o, g in zip(
        jax_fn(*a), gs)), argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    return p32, p64, [np.asarray(g, np.float64) for g in jg]
