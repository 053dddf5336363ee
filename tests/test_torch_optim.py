"""The port's optimizer and gradient compression against JAX's.

``optim/adamw.py`` (schedule, apply with f32 masters, clipping, decay on
matrices, bf16 moments) and ``optim/grad_compress.py`` (bf16, int8 with
error feedback, round half to even) on the same numpy inputs; then the
train step with each compression and with ``microbatch=2`` against JAX's
over three steps (f32 losses at 1e-5, bf16 at 2e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadam
from repro.optim import grad_compress as jgc
from repro_torch.optim import adamw as tadam
from repro_torch.optim import grad_compress as tgc

from torch_train_parity import (  # noqa: F401 (a fixture)
    LOSS_TOL, as_f32, bridge, get_reduced, jax_run, one_torch_thread,
    state_gaps, torch_run)

STATE_TOL = {"f32": 1e-4, "bf16": 2e-2}


def _tree(seed, dtype=np.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(16, 8)) * scale).astype(dtype),
            "stack": [(rng.normal(size=(4, 8)) * scale).astype(dtype)
                      for _ in range(2)],
            "b": (rng.normal(size=(8,)) * scale).astype(dtype)}


def _jax(tree):
    return {"w": jnp.asarray(tree["w"]), "stack": [jnp.asarray(a) for a in
                                                   tree["stack"]],
            "b": jnp.asarray(tree["b"])}


def _torch(tree, dtype=None):
    def one(a):
        t = torch.from_numpy(np.array(a, np.float32))
        return t.to(dtype) if dtype is not None else t
    return {"w": one(tree["w"]), "stack": [one(a) for a in tree["stack"]],
            "b": one(tree["b"])}


def _flat(tree):
    def one(a):
        return a.float().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a, np.float32)
    return [one(tree["w"]), *(one(a) for a in tree["stack"]), one(tree["b"])]


def test_schedule_matches_jax():
    for cfg in ((10, 2), (1000, 20), (5, 0)):
        jc = jadam.AdamWConfig(total_steps=cfg[0], warmup_steps=cfg[1])
        tc = tadam.AdamWConfig(total_steps=cfg[0], warmup_steps=cfg[1])
        for step in range(0, cfg[0] + 3):
            want = float(jadam.schedule(jc, jnp.int32(step)))
            got = float(tadam.schedule(tc, torch.tensor(step)))
            np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("pdtype,mdtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_adamw_apply_matches_jax(pdtype, mdtype):
    """Three updates from the same params and grads: params, moments and
    masters, the clip (grad_clip below the norm) and the decay of
    ``ndim >= 2`` leaves only."""
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    kw = dict(total_steps=10, warmup_steps=1, grad_clip=0.5)
    jc = jadam.AdamWConfig(**kw, moments_dtype=jd[mdtype])
    tc = tadam.AdamWConfig(**kw, moments_dtype=mdtype)
    params = _tree(0, scale=0.3)
    jp = jax.tree.map(lambda a: a.astype(jd[pdtype]), _jax(params))
    tp = _torch(params, pdtype)
    js, ts = jadam.init(jp, jc), tadam.init(tp, tc)
    for step in range(3):
        grads = _tree(10 + step)
        jp, js, jm = jax.jit(lambda p, g, s: jadam.apply(p, g, s, jc))(
            jp, _jax(grads), js)
        tp, ts, tm = tadam.apply(tp, _torch(grads), ts, tc)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        tol = 1e-6 if pdtype == torch.float32 else 1e-2
        for t_tree, j_tree in ((tp, jp), (ts.master, js.master),
                               (ts.mu, js.mu), (ts.nu, js.nu)):
            for got, want in zip(_flat(t_tree), _flat(j_tree)):
                np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert int(ts.step) == 3 and ts.mu["w"].dtype == mdtype
    assert tp["w"].dtype == pdtype and ts.master["w"].dtype == torch.float32


def test_compress_bf16_matches_jax():
    g = _tree(3)
    for got, want in zip(_flat(tgc.compress_bf16(_torch(g))),
                         _flat(jgc.compress_bf16(_jax(g)))):
        np.testing.assert_array_equal(got, want)


def test_compress_int8_ef_matches_jax():
    """Eager JAX, same f32 division: dq and the error carry are
    bit-equal; with ``groups`` the two members of ``stack`` share one
    scale, as the reference's one stacked leaf has."""
    g, e = _tree(4, scale=1e-3), _tree(5, scale=1e-5)
    jdq, jerr = jgc.compress_int8_ef(_jax(g), _jax(e))
    tdq, terr = tgc.compress_int8_ef(_torch(g), _torch(e))
    for got, want in zip(_flat(tdq) + _flat(terr), _flat(jdq) + _flat(jerr)):
        np.testing.assert_array_equal(got, want)
    # the reference's stacked leaf: one (2, 4, 8) tensor, one scale
    stacked = {"w": g["w"], "stack": np.stack(g["stack"]), "b": g["b"]}
    stacked_e = {"w": e["w"], "stack": np.stack(e["stack"]), "b": e["b"]}
    jdq, jerr = jgc.compress_int8_ef(jax.tree.map(jnp.asarray, stacked),
                                     jax.tree.map(jnp.asarray, stacked_e))
    groups = {"w": "w", "stack": ["stack", "stack"], "b": "b"}
    tdq, terr = tgc.compress_int8_ef(_torch(g), _torch(e), groups)
    for got, want in ((tdq["stack"], jdq["stack"]),
                      (terr["stack"], jerr["stack"])):
        np.testing.assert_array_equal(torch.stack(got).numpy(),
                                      np.asarray(want))
    # round half to even, as jnp.round
    half = {"w": np.array([[0.5, 1.5, 2.5, -0.5, 127.0]], np.float32)}
    jq = jgc._quant_int8(jnp.asarray(half["w"]))[0]
    tq = tgc._quant_int8(torch.from_numpy(half["w"]))[0]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


CASES = {   # name: (grad_compress, microbatch)
    "compress_bf16": ("bf16", 0),
    "compress_int8_ef": ("int8_ef", 0),
    "microbatch2": ("none", 2),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_train_step_with_compression_and_microbatch_matches_jax(case, dtype):
    gc, mb = CASES[case]
    init, jout = jax_run("llama3-8b", dtype, "bf16:dense:jnp", gc, mb)
    tout = torch_run("llama3-8b", dtype, "bf16:dense:torch", init, gc, mb)
    for (tm, _), (jm, _) in zip(tout, jout):
        assert abs(tm["loss"] / jm["loss"] - 1) <= LOSS_TOL[dtype], (tm, jm)
    cfg = get_reduced("llama3-8b")
    gaps = state_gaps(cfg, tout[-1][1], jout[-1][1])
    assert max(gaps.values()) <= STATE_TOL[dtype], gaps
    if gc == "int8_ef":
        got = jax.tree.leaves(bridge.params_to_numpy(
            tout[-1][1].grad_error, cfg))
        want = jax.tree.leaves(as_f32(jout[-1][1].grad_error))
        off = 0
        for a, b in zip(got, want):
            # a residual jumps by one int8 step (twice the largest
            # residual) where an element sits at a half step and the two
            # packages' gradients part by an f32 ulp there
            step = 2 * np.abs(b).max()
            assert np.max(np.abs(a - b)) <= step * (1 + 1e-3) + 1e-12
            off += int((np.abs(a - b) > 1e-3 * step).sum())
        if dtype == "f32":      # measured: 162 of 574,080 elements
            assert off <= 1e-3 * sum(a.size for a in got), off
