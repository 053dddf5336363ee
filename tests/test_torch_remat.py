"""``remat="dots"`` in the port's training forward
(``models/transformer._remat``): the twin of the reference's
``dots_with_no_batch_dims_saveable`` keeps the linears' 2-D products and
recomputes the rest. Its losses and gradients are bit-equal to ``"full"``'s
and ``"none"``'s on the CPU, its recompute issues no 2-D product, and three
train steps match the reference's under ``"dots"``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_reduced as j_reduced
from repro.runtime import train_loop as jtl
from repro_torch import bridge
from repro_torch.configs import get_reduced
from repro_torch.core import tree
from repro_torch.models import transformer as tf
from repro_torch.runtime import train_loop as ttl
from torch_train_parity import (  # noqa: F401
    LOSS_TOL, batches, init_params, one_torch_thread, opt_cfgs, rts,
    state_gaps, to_jax, to_torch)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _grads(cfg, params, batch, rt, count=None):
    loss_fn = ttl.make_loss_fn(cfg, rt)
    if count is None:
        return ttl.value_and_grad(loss_fn)(params, batch)
    with count:
        return ttl.value_and_grad(loss_fn)(params, batch)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dots_is_bit_equal_to_full_and_none(dtype):
    base = get_reduced("llama3-8b")
    _, trt = rts(dtype)
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    params = tf.init_params(base, torch.Generator().manual_seed(0),
                            dtype=tdt)
    batch = to_torch(batches(base, 1)[0])
    res, mms = {}, {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        count = _CountMM()
        (loss, _), grads = _grads(cfg, params, batch, trt, count)
        res[remat] = (loss, tree.leaves(grads))
        mms[remat] = count.n
    for remat in ("full", "dots"):
        assert torch.equal(res[remat][0], res["none"][0])
        for a, b in zip(res[remat][1], res["none"][1]):
            assert torch.equal(a, b)
    # the recompute under "dots" issues no 2-D product (the linears' are
    # kept); under "full" it runs the linears again
    assert mms["dots"] == mms["none"]
    assert mms["full"] > mms["none"]


def test_dots_three_steps_match_jax():
    """Three train steps under ``remat="dots"`` against the reference's,
    in f32, at ``test_three_steps_match_jax``'s tolerance."""
    jcfg = dataclasses.replace(j_reduced("llama3-8b"), remat="dots")
    cfg = dataclasses.replace(get_reduced("llama3-8b"), remat="dots")
    jopt, topt = opt_cfgs()
    jrt, trt = rts("f32")
    params = init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    jstate = jtl.init_state(params, jopt)
    state = bridge.train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                          cfg)
    jstep = jax.jit(jtl.make_train_step(jcfg, jopt, jrt))
    step = ttl.make_train_step(cfg, topt, trt)
    for batch in batches(cfg):
        jstate, jm = jstep(jstate, to_jax(batch))
        state, m = step(state, to_torch(batch))
        assert abs(float(m["loss"]) / float(jm["loss"]) - 1) \
            <= LOSS_TOL["f32"]
    gaps = state_gaps(cfg, state, jax.tree.map(np.asarray, jstate))
    assert max(gaps.values()) <= 1e-4, gaps


def test_dots_recomputes_the_kernel_launch(monkeypatch):
    """Under a kernel backend the GEMM runs inside the registry's autograd
    Function, which the policy cannot keep: kernel A is called twice per
    linear under ``"dots"``, as under ``"full"`` (the rule the card's
    ``[dist]`` check holds), and the gradients are bit-equal."""
    from repro_torch.core import execution as tex
    from repro_torch.kernels import fp8_matmul as tfm
    base = get_reduced("llama3-8b")
    params = tf.init_params(base, torch.Generator().manual_seed(0))
    batch = to_torch(batches(base, 1)[0])
    calls = [0]
    orig = tfm.fp8_matmul

    def counting(*a, **k):
        calls[0] += 1
        return orig(*a, **k)
    monkeypatch.setattr(tfm, "fp8_matmul", counting)
    got = {}
    for remat in ("none", "full", "dots"):
        cfg, rt = tex.apply_policy(dataclasses.replace(base, remat=remat),
                                   rts("f32")[1],
                                   tex.parse_policy("bf16:dense:hopper"))
        calls[0] = 0
        (loss, _), grads = _grads(cfg, params, batch, rt)
        got[remat] = (calls[0], loss, tree.leaves(grads))
    linears = 7 * base.num_layers
    assert got["none"][0] == linears + 2          # the head, CE remat
    assert got["full"][0] == got["dots"][0] == 2 * linears + 2
    assert torch.equal(got["full"][1], got["dots"][1])
    assert all(torch.equal(a, b)
               for a, b in zip(got["full"][2], got["dots"][2]))
