"""Greedy serving of the MoE, local/global and widest dense stacks against
the JAX ServeSession: the reduced granite-moe-3b-a800m (40 → 8 experts,
top-2), llama4-scout-17b-a16e (top-1 with a shared expert) and gemma3-12b
(5 local : 1 global, window 64), dense and paged; chameleon-34b (an
embeddings-input stack, served from its token table) and deepseek-67b
dense; llama3-405b (8 query heads over 2 kv heads of 16) dense and paged;
and a slot handoff that carries a rolling window.

Both sessions serve the same requests from the same JAX init (bridged bit
for bit). In f32 the tokens must be equal; in bf16 a token may flip only
at a near-tie (test_torch_serve.py). MoE prompts keep to lengths whose
token count the reduced group size of 64 divides (or that fit one group),
as the reference requires; gemma3 gets one prompt past its window.
"""
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
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.core import execution as tex
from repro_torch.models import transformer as tt
from repro_torch.models.layers import RuntimeCfg as TRt
from repro_torch.runtime import serve_loop as tsl
from test_torch_serve import NEAR_TIE, _run_port
from torch_train_parity import one_torch_thread  # noqa: F401 (a fixture)

ARCHS = ["granite-moe-3b-a800m", "llama4-scout-17b-a16e", "gemma3-12b",
         "chameleon-34b", "deepseek-67b", "llama3-405b"]
PROMPT_LENS = {"granite-moe-3b-a800m": (5, 40, 64, 8),
               "llama4-scout-17b-a16e": (5, 40, 64, 8),
               "gemma3-12b": (70, 8, 40, 5),
               "chameleon-34b": (5, 40, 64, 8),
               "deepseek-67b": (5, 40, 64, 8),
               "llama3-405b": (5, 40, 64, 8)}
# the widest dense stacks share one paged layout, held on llama3-405b alone
F32_CASES = [(arch, paged) for arch in ARCHS for paged in (False, True)
             if not paged or arch not in ("chameleon-34b", "deepseek-67b")]
MAX_NEW, MAX_LEN, SLOTS, PAGE = 6, 96, 2, 16
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _prompts(cfg, arch):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
            for n in PROMPT_LENS[arch]]


def _serve_both(arch, dtype, paged):
    cfg = get_reduced(arch)
    jdt, tdt = DTYPES[dtype]
    params = init_params(jax.random.PRNGKey(0), cfg, dtype=jdt)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    kw = dict(paged=True, page_size=PAGE) if paged else {}
    jsess = jsl.ServeSession(
        params, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
        rt=JRt(act_dtype=jdt, param_dtype=jdt, use_pallas=True),
        policy=jex.parse_policy("bf16:dense:pallas"), **kw)
    tsess = tsl.ServeSession(
        tparams, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
        rt=TRt(act_dtype=tdt, use_pallas=True),
        policy=tex.parse_policy("bf16:dense:hopper"), device="cpu", **kw)
    for uid, prompt in enumerate(_prompts(cfg, arch)):
        jsess.submit(jsl.Request(uid=uid, prompt=prompt, max_new=MAX_NEW))
        tsess.submit(tsl.Request(uid=uid, prompt=prompt, max_new=MAX_NEW))
    want = {r.uid: r.out for r in jsess.run()}
    got, margins = _run_port(tsess)
    return want, got, margins


@pytest.mark.parametrize("arch,paged", F32_CASES)
def test_greedy_tokens_match_jax_in_f32(arch, paged):
    want, got, _ = _serve_both(arch, "f32", paged)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    assert got == want


# llama4-scout is held in f32 only: its bf16 run (top-1 routing over 4
# experts of capacity 1 at decode) flips a token at a logit margin of 0.31,
# which the logit near-tie rule cannot account for: a near-tie of the
# router, where a bf16 rounding picks the other expert, moves the logits
# far more than a rounding of the logits themselves. The router's tie is
# within one bf16 ulp of its input (tests/test_torch_router_tie.py).
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "gemma3-12b"])
def test_greedy_tokens_match_jax_in_bf16_up_to_a_near_tie(arch):
    want, got, margins = _serve_both(arch, "bf16", False)
    assert sorted(got) == sorted(want)
    for uid in want:
        assert len(got[uid]) == len(want[uid]) == MAX_NEW
        flip = next((i for i, (a, b) in enumerate(zip(got[uid], want[uid]))
                     if a != b), None)
        if flip is not None:
            assert margins[(uid, flip)] < NEAR_TIE["bf16"], (uid, flip)


@pytest.mark.parametrize("paged", [False, True])
def test_handoff_carries_the_rolling_window(paged):
    """gemma3: a request whose prompt already rolled its window is exported
    after two decode steps and imported into a second session; its export
    holds each local layer's whole window (64 rows) and each global
    layer's rows (dense) or pages (paged), and it resumes with the tokens
    of an uninterrupted run."""
    cfg = t_get_reduced("gemma3-12b")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            dtype=torch.float32)
    kw = dict(paged=True, page_size=PAGE) if paged else {}

    def session():
        return tsl.ServeSession(params, cfg, batch_slots=SLOTS,
                                max_len=MAX_LEN,
                                rt=TRt(act_dtype=torch.float32),
                                device="cpu", **kw)

    prompt = _prompts(cfg, "gemma3-12b")[0]                  # 70 tokens
    plain = session()
    plain.submit(tsl.Request(uid=0, prompt=prompt, max_new=10))
    want = plain.run()[0].out
    src, dst = session(), session()
    src.admit(tsl.Request(uid=0, prompt=prompt, max_new=10))
    src.decode_once()
    src.decode_once()
    exp = src.export_slot(0)
    for kind, layer in zip(tt.layer_kinds(cfg), exp.caches):
        if kind == "attn_local":
            assert layer["k"].shape[0] == cfg.window_size
            assert int(layer["pos"].max()) == exp.pos - 1
        elif paged:
            assert layer["k"].shape[:2] == (exp.pages, PAGE)
        else:
            assert layer["k"].shape[0] == MAX_LEN
    assert src.n_active == 0
    slot = dst.import_slot(exp)
    while dst.n_active:
        dst.decode_once()
    assert dst.completed[0].out == want
    assert slot == 0


def test_block_kinds_admitted_and_refused():
    """Every arch's block kinds are admitted (all of ``ARCH_NAMES``, full
    and reduced): the attention-style stacks with no state blocks for the
    pager to account (their windows are slot-indexed K/V, as in JAX), and
    the recurrent ones (rwkv6; zamba2's mamba2, shared attention and
    hybrid tail) with JAX's state block size. A block kind the port does
    not know is refused."""
    import types
    from repro.core import paging as jpaging
    from repro_torch.configs import ARCH_NAMES, get_arch
    from repro_torch.core import paging as tpaging
    recurrent = ("rwkv6-3b", "zamba2-1.2b")
    assert set(ARCHS + ["llama3-8b"] + list(recurrent)) < set(ARCH_NAMES)
    for arch in ARCH_NAMES:
        tt.check_supported(get_arch(arch))
        tt.check_supported(t_get_reduced(arch))
        if arch not in recurrent:
            assert tpaging.state_block_tokens(t_get_reduced(arch)) == 0 \
                == jpaging.state_block_tokens(get_reduced(arch))
    for arch in recurrent:
        cfg = t_get_reduced(arch)
        tt.check_supported(cfg)
        assert tpaging.state_block_tokens(cfg) == \
            jpaging.state_block_tokens(get_reduced(arch)) > 0
        caches = tt.init_cache(cfg, 1, 8)
        assert len(caches) == len(tt.layer_kinds(cfg))
        assert any(kind in tt.STATE_KINDS for kind in tt.layer_kinds(cfg))
    with pytest.raises(NotImplementedError, match="cross_attn"):
        tt.check_supported(types.SimpleNamespace(
            name="x", superlayer_pattern=("attn_dense", "cross_attn")))
