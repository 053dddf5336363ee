"""Shared set-up of the port's runtime parity tests (not a test module).

Reduced llama3-8b in f32, one JAX init bridged bit for bit to the port,
and seeded requests built the same way for both packages. In f32 greedy
tokens are exact, so every comparison of tokens and step accounting is an
equality.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_reduced
from repro.models import init_params
from repro.models.layers import RuntimeCfg as JRt
from repro.runtime import serve_loop as jsl
from repro_torch import bridge
from repro_torch.models.layers import RuntimeCfg as TRt
from repro_torch.runtime import serve_loop as tsl

CFG = get_reduced("llama3-8b")
JRT = JRt(act_dtype=jnp.float32, param_dtype=jnp.float32)
TRT = TRt(act_dtype=torch.float32)
MAX_LEN = 64


@functools.lru_cache(maxsize=1)
def params():
    """(JAX params, port params): one f32 init, bridged."""
    jp = init_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), CFG)
    return jp, tp


def requests(tenant_idx, n=2, max_new=6, length=5):
    """The same seeded requests as (JAX Requests, port Requests)."""
    rng = np.random.default_rng(tenant_idx)
    prompts = [rng.integers(0, CFG.vocab_size, length).astype(np.int32)
               for _ in range(n)]
    return tuple([mod.Request(uid=tenant_idx * 100 + j, prompt=p.copy(),
                              max_new=max_new)
                  for j, p in enumerate(prompts)] for mod in (jsl, tsl))


def outs(reqs):
    return {r.uid: list(r.out) for r in reqs}


def steps(reqs):
    """Per request: (submit_step, admit_step, finish_step)."""
    return {r.uid: (r.submit_step, r.admit_step, r.finish_step)
            for r in reqs}


TENANT_FIELDS = ("tenant_id", "completed", "tokens_out", "service_steps",
                 "mean_turnaround_steps", "mean_queue_wait_steps",
                 "submitted", "partition", "migrations", "slo",
                 "slo_attainment", "spec_steps", "spec_drafted",
                 "spec_accepted")


def tenant_rows(report):
    """The step-domain fields of every TenantReport (wall-clock ones
    differ by machine)."""
    return [{f: getattr(t, f) for f in TENANT_FIELDS}
            for t in report.tenants]
