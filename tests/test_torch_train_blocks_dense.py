"""Training the local/global and embeddings-input block kinds against
JAX: step-0 gradients and three steps.

Reduced gemma3-12b (one 5 local : 1 global super-layer, window 64) and
musicgen-medium (seeded normal frames as ``(B, S, d)`` embeddings input,
``tests/torch_train_parity.batches``), f32, every leaf within 1e-5 of
the leaf's largest entry, under ``bf16:dense:hopper`` against
``bf16:dense:pallas`` (measured worst: gemma3 1.7e-6, musicgen 1.1e-6).

* gemma3 also at S=128 (B=2), past its window of 64, so that the local
  layers' mask cuts keys off, in the forward and in the gradients; at
  S=32 every key lies within the window.
* musicgen: three f32 steps of each package from one init, the losses
  and the state after them within ``check_three_steps``' tolerances; its
  token table, which the stack never reads, gets a gradient of exactly
  zero in both packages, and AdamW moves it by the decoupled decay alone.
"""
import numpy as np
import pytest

from repro.configs import get_reduced
from repro_torch import bridge
from torch_train_parity import (  # noqa: F401 (a fixture)
    GRAD_TOL, HOPPER, batches, check_step0_grads, check_three_steps,
    jax_run, one_torch_thread, opt_cfgs, step0_grads, to_torch, torch_step)

MUSICGEN = "musicgen-medium"


@pytest.mark.parametrize("arch", ["gemma3-12b", "musicgen-medium"])
def test_step0_grads_match_jax(arch):
    check_step0_grads(arch, GRAD_TOL)


def test_step0_grads_match_jax_where_the_window_masks():
    """gemma3 at S=128, B=2: past the reduced window of 64."""
    check_step0_grads("gemma3-12b", GRAD_TOL, b=2, s=128)


def test_three_f32_steps_of_the_embeddings_input_match_jax():
    check_three_steps(MUSICGEN, "f32", *HOPPER)


def test_unread_token_table_gets_zero_gradient_and_decay_only():
    """The token table of an embeddings-input stack: exactly zero step-0
    gradient in both packages; after each of three steps, zero moments
    and a master moved by the decoupled decay alone, master - lr · (wd ·
    master) in f32 at the step's learning rate."""
    got, want = next((g, w) for name, g, w in step0_grads(MUSICGEN, *HOPPER)
                     if name == "['embed']")
    assert got.shape == want.shape
    assert not got.any() and not want.any()
    init, jout = jax_run(MUSICGEN, "f32", HOPPER[0])
    cfg = get_reduced(MUSICGEN)
    # the port updates its state in place: each step is read as it ends
    tstate = bridge.train_state_from_numpy(init, cfg)
    step = torch_step(MUSICGEN, "f32", HOPPER[1])
    wd = np.float32(opt_cfgs()[1].weight_decay)
    master = np.asarray(init.opt.master["embed"], np.float32)
    for batch, (jm, jstate) in zip(batches(cfg), jout):
        tstate, tm = step(tstate, to_torch(batch))
        assert float(tm["lr"]) == jm["lr"]
        master = master - np.float32(jm["lr"]) * (wd * master)
        for mu, nu, new in ((tstate.opt.mu["embed"].numpy(),
                             tstate.opt.nu["embed"].numpy(),
                             tstate.opt.master["embed"].numpy()),
                            (jstate.opt.mu["embed"], jstate.opt.nu["embed"],
                             jstate.opt.master["embed"])):
            assert not np.asarray(mu).any() and not np.asarray(nu).any()
            np.testing.assert_allclose(np.asarray(new), master, rtol=1e-6,
                                       atol=0)
        assert not np.array_equal(master, np.asarray(
            init.opt.master["embed"]))
