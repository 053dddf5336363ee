"""The port's train step on every reduced arch, and granite's aux loss
against JAX's (f32, three steps).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.models import init_params as t_init
from repro_torch.optim import adamw as tadam
from repro_torch.runtime import train_loop as ttl

from torch_train_parity import (  # noqa: F401 (a fixture)
    bridge, jax_run, one_torch_thread, rts, torch_run)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_step_no_nans(arch):
    """Twin of ``test_models.py::test_train_step_no_nans`` on the port:
    one step from a seeded init, finite loss and params."""
    cfg = t_reduced(arch)
    params = t_init(cfg, torch.Generator().manual_seed(0))
    opt = tadam.AdamWConfig(total_steps=10, warmup_steps=2)
    state = ttl.init_state(params, opt)
    step = ttl.make_train_step(cfg, opt, rts("bf16")[1])
    rng = np.random.default_rng(0)
    if cfg.input_mode == "embeddings":
        inputs = torch.from_numpy(rng.normal(size=(2, 64, cfg.d_model))
                                  .astype(np.float32)).to(torch.bfloat16)
    else:
        inputs = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
    state, metrics = step(state, {"inputs": inputs, "labels": labels})
    assert np.isfinite(float(metrics["loss"]))
    for leaf in jax.tree.leaves(bridge.params_to_numpy(state.params, cfg)):
        assert np.isfinite(leaf).all()


def test_granite_aux_loss_matches_jax_in_f32():
    """The MoE aux loss enters the loss at AUX_LOSS_WEIGHT; in f32 the
    routing agrees, so loss, CE and aux match JAX's over three steps."""
    arch = "granite-moe-3b-a800m"
    init, jout = jax_run(arch, "f32", "bf16:dense:jnp")
    tout = torch_run(arch, "f32", "bf16:dense:torch", init)
    for (tm, _), (jm, _) in zip(tout, jout):
        assert tm["aux"] > 0
        for key in ("loss", "ce", "aux"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5,
                                       err_msg=key)
