"""The port's train step against JAX's ``make_train_step``.

Reduced llama3-8b, one JAX init bridged bit for bit, the same
``SyntheticLM`` batches, three steps of each. In f32 the two differ only
in the order of f32 sums: losses at 1e-5 relative, the state after three
steps within 1e-4 (measured: at most 5.6e-6 for params and masters). In
bf16 at the JAX package's own tolerance (2e-2, as
``test_microbatch_matches_full_batch``). Also here: the kernel calls
per step against the rule the card's launch check holds. ``test_torch_train_grads.py`` holds the step-0 gradients and the
two gradient faults this slice repaired, ``test_torch_train_archs.py``
every reduced arch and granite's aux loss.
"""
import pytest
import torch

from repro_torch.configs import get_reduced as t_reduced
from repro_torch.models import init_params as t_init
from repro_torch.models.layers import RuntimeCfg as TRt
from repro_torch.optim import adamw as tadam
from repro_torch.runtime import train_loop as ttl

from torch_train_parity import (  # noqa: F401 (a fixture)
    check_three_steps, one_torch_thread)

CASES = {   # name: (JAX policy, port policy)
    "torch": ("bf16:dense:jnp", "bf16:dense:torch"),
    "hopper": ("bf16:dense:pallas", "bf16:dense:hopper"),
    "sparse24_ste": ("bf16:sparse24:pallas", "bf16:sparse24:hopper"),
    "hopper_sparse24": ("bf16:dense:pallas_sparse24",
                        "bf16:dense:hopper_sparse24"),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_jax(case, dtype):
    check_three_steps("llama3-8b", dtype, *CASES[case])


@pytest.mark.parametrize("spec,want_a,want_d,seq", [
    ("bf16:dense:hopper", "bf16", 0, 64),
    ("bf16:dense:hopper", "bf16", 0, 1024),      # two CE chunks
    ("fp8:dense:hopper", "dense", 0, 64),
    ("bf16:sparse24:hopper", "bf16", 0, 64),
    ("bf16:dense:hopper_sparse24", "head", "linears", 64),
    ("bf16:dense:hopper_sparse24", "head", "linears", 1024),
    ("bf16:dense:torch", 0, 0, 64)])
def test_kernel_calls_per_step_follow_the_remat_rule(monkeypatch, spec,
                                                     want_a, want_d, seq):
    """The rule the card's launch check holds the train step to: with the
    super-layers and each CE chunk checkpointed, each linear's kernel runs
    twice per step (forward, and again in backward), the head twice per
    CE chunk. A bf16 linear's backward is two more calls of kernel A (dX
    and dW); the fp8 and 2:4 entries' backward and the head's f32 one call
    no kernel. Counted here as calls of the kernel wrappers, which launch
    once per call on the card."""
    from repro_torch.core import execution as tex
    from repro_torch.kernels import fp8_matmul as tfm
    from repro_torch.kernels import sparse24_matmul as tsm
    calls = {"A": 0, "D": 0}
    real_a, real_d = tfm.fp8_matmul, tsm.sparse24_matmul

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(tfm, "fp8_matmul", count("A", real_a))
    monkeypatch.setattr(tsm, "sparse24_matmul", count("D", real_d))
    cfg = t_reduced("llama3-8b")
    opt = tadam.AdamWConfig()
    state = ttl.init_state(t_init(cfg, torch.Generator().manual_seed(0)), opt)
    step = ttl.make_train_step(cfg, opt, TRt(),
                               policy=tex.parse_policy(spec))
    tokens = torch.randint(0, cfg.vocab_size, (1, seq))
    step(state, {"inputs": tokens, "labels": tokens})
    linears = 2 * 7 * cfg.num_layers
    head = 2 * (seq // min(ttl.CE_CHUNK, seq))
    n = {"dense": linears + head, "bf16": 2 * linears + head, "head": head,
         "linears": linears, 0: 0}
    assert calls == {"A": n[want_a], "D": n[want_d]}
