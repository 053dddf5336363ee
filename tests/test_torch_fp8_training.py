"""FP8 training in the port against JAX: the delayed-scaling primitives
(``TensorScale``, ``update_scale``, ``quantize``, ``fp8_matmul`` with its
E5M2 backward, ``fp8_linear``, ``fold_amaxes``) and the train step under
``fp8:dense``.

The train step in f32 is held step by step from JAX's own state (each
step's loss at 1e-5): free running, a one-ulp difference of an f32 sum
can move an activation across an e4m3 rounding boundary (one fp8 ulp, a
sixteenth of the value), and Adam's first updates, about lr·sign(g), turn
a near-zero gradient's flipped sign into a 2·lr step of that element. At
B=2, S=32 that parted the free-running f32 losses by 2.6e-4 after step 0
(measured in development), while every step from the same state agrees
within 1e-5. In bf16 the run is free, at 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fp8 as jfp8
from repro_torch.core import fp8 as tfp8

from torch_train_parity import (  # noqa: F401 (a fixture)
    LOSS_TOL, batches, bridge, get_reduced, jax_run, one_torch_thread,
    to_torch, torch_run, torch_step)

JD = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(shape, seed, dtype, scale=1.0):
    a = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    jd, td = JD[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(t):
    return (t.float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32))


def test_delayed_scaling_state_matches_jax():
    """update_scale over a rolling history (zero guard, roll-out),
    quantize, dequantize_scale and current_amax: bit-equal."""
    jts, tts = jfp8.TensorScale.init(4), tfp8.TensorScale.init(4)
    for amax in (0.0, 1.0, 10.0, 2.0, 3.0, 0.5, 0.25, 7.0):
        jts = jfp8.update_scale(jts, jnp.float32(amax))
        tts = tfp8.update_scale(tts, torch.tensor(amax))
        assert np.array_equal(_np(tts.amax_history), _np(jts.amax_history))
        assert _np(tts.scale) == _np(jts.scale)
        assert _np(tfp8.dequantize_scale(tts)) == _np(
            jfp8.dequantize_scale(jts))
    jx, tx = _pair((16, 32), 1, "f32", 9.0)
    for dt in ((jfp8.E4M3, tfp8.E4M3), (jfp8.E5M2, tfp8.E5M2)):
        want = np.asarray(jfp8.quantize(jx, jts, dt[0]).astype(jnp.float32))
        assert np.array_equal(_np(tfp8.quantize(tx, tts, dt[1])), want)
    assert _np(tfp8.current_amax(tx)) == _np(jfp8.current_amax(jx))


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fp8_matmul_and_its_gradients_match_jax(dtype, backend):
    """Forward on the same e4m3 bytes (f32 sums only reorder); backward:
    g quantized to e5m2 with its current amax, dx and dw in the primal
    dtypes, zero gradients for the scales (JAX's
    ``test_fp8_matmul_grad_dtype_matches_bf16_params`` and
    ``test_scale_gradients_are_zero``)."""
    jx, tx = _pair((2, 8, 64), 2, dtype)
    jw, tw = _pair((64, 24), 3, dtype, 64 ** -0.5)
    jg, tg = _pair((2, 8, 24), 4, "f32", 3.0)
    xs, ws = np.float32(100.0), np.float32(300.0)

    def jloss(x, w, a, b):
        return jnp.sum(jfp8.fp8_matmul(x, w, a, b, jfp8.E4M3, jfp8.E5M2,
                                       "jnp").astype(jnp.float32) * jg)
    jout = jfp8.fp8_matmul(jx, jw, jnp.float32(xs), jnp.float32(ws))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jx, jw, jnp.float32(xs), jnp.float32(ws))
    targs = [tx.requires_grad_(True), tw.requires_grad_(True),
             torch.tensor(xs, requires_grad=True),
             torch.tensor(ws, requires_grad=True)]
    tout = tfp8.fp8_matmul(*targs, backend=backend)
    tgrads = torch.autograd.grad((tout.float() * tg).sum(), targs)
    assert tout.dtype == JD[dtype][1]
    tol = 1e-5 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(_np(tout.detach()), _np(jout), rtol=tol,
                               atol=tol)
    for got, want in zip(tgrads, jgrads):
        assert str(got.dtype) == f"torch.{want.dtype}"
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                                   atol=tol * np.abs(_np(want)).max())
    assert float(tgrads[2]) == 0.0 and float(tgrads[3]) == 0.0


def test_fp8_linear_and_fold_amaxes_match_jax():
    """Two steps of a delayed-scaling linear: the first at the initial
    scale 1, the next at the scales folded from the first's amaxes."""
    jstate, tstate = (jfp8.init_fp8_state(["l1"], history=4),
                      tfp8.init_fp8_state(["l1"], history=4))
    for step in range(2):
        jx, tx = _pair((4, 32), 10 + step, "f32", 20.0)
        jw, tw = _pair((32, 8), 20 + step, "f32", 0.5)
        jc, tc = {}, {}
        jout = jfp8.fp8_linear(jx, jw, jstate, "l1", collect=jc)
        tout = tfp8.fp8_linear(tx, tw, tstate, "l1", collect=tc)
        np.testing.assert_allclose(_np(tout), _np(jout), rtol=1e-5,
                                   atol=1e-5)
        assert set(tc) == set(jc) == {"l1/x", "l1/w"}
        jstate, tstate = (jfp8.fold_amaxes(jstate, jc),
                          tfp8.fold_amaxes(tstate, tc))
        for k in jstate:
            assert _np(tstate[k].scale) == _np(jstate[k].scale)
            assert np.array_equal(_np(tstate[k].amax_history),
                                  _np(jstate[k].amax_history))


@pytest.mark.parametrize("jspec,tspec", [("fp8:dense:pallas",
                                          "fp8:dense:hopper")])
def test_fp8_train_steps_from_jax_state_match_in_f32(jspec, tspec):
    """Each of three steps from JAX's state before it: the port's loss at
    1e-5, and its state after it within 1e-4 of JAX's (measured: 1.5e-5,
    a few near-zero gradients' Adam signs)."""
    cfg = get_reduced("llama3-8b")
    init, jout = jax_run("llama3-8b", "f32", jspec)
    step = torch_step("llama3-8b", "f32", tspec)
    prev = init
    for batch, (jm, jstate) in zip(batches(cfg), jout):
        state, tm = step(bridge.train_state_from_numpy(prev, cfg),
                         to_torch(batch))
        assert abs(float(tm["loss"]) / jm["loss"] - 1) <= 1e-5
        got = jax.tree.leaves(bridge.params_to_numpy(state.params, cfg))
        want = jax.tree.leaves(jax.tree.map(
            lambda a: np.asarray(a, np.float32), jstate.params))
        assert max(np.max(np.abs(a - b)) for a, b in zip(got, want)) <= 1e-4
        prev = jstate


@pytest.mark.parametrize("jspec,tspec", [("fp8:dense:jnp", "fp8:dense:torch"),
                                         ("fp8:dense:pallas",
                                          "fp8:dense:hopper")])
def test_fp8_three_steps_match_jax_in_bf16(jspec, tspec):
    init, jout = jax_run("llama3-8b", "bf16", jspec)
    tout = torch_run("llama3-8b", "bf16", tspec, init)
    for (tm, _), (jm, _) in zip(tout, jout):
        assert np.isfinite(tm["loss"])
        assert abs(tm["loss"] / jm["loss"] - 1) <= LOSS_TOL["bf16"]
