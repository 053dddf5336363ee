"""``chip_smoke.train_launches_expected`` against the kernel calls a train
step makes, on every block kind the card trains.

The card's launch gate holds each train arm to the count this function
derives from the code. Here one step of each reduced arch (super-layers
checkpointed, as the full configs are) runs on the CPU with the kernel
wrappers counted (they launch once per call on the card): kernel A's
calls, its expert-batched calls among them, and kernel D's. The
``[train]`` arms of llama3-8b (8 layers, B=4, S=512, three steps) keep
the counts they had when the function knew llama's 7 linears only.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core import execution as tex
from repro_torch.kernels import fp8_matmul as tfm
from repro_torch.kernels import sparse24_matmul as tsm
from repro_torch.models import init_params
from repro_torch.models.layers import RuntimeCfg
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop as ttl

from torch_train_parity import one_torch_thread  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,spec", [
    ("llama3-8b", "bf16:dense:hopper"),
    ("granite-moe-3b-a800m", "bf16:dense:hopper"),
    ("granite-moe-3b-a800m", "fp8:dense:hopper"),
    ("granite-moe-3b-a800m", "bf16:dense:hopper_sparse24"),
    ("granite-moe-3b-a800m", "bf16:dense:torch"),
    ("llama4-scout-17b-a16e", "bf16:dense:hopper"),
    ("zamba2-1.2b", "bf16:dense:hopper"),
    ("zamba2-1.2b", "bf16:dense:hopper_sparse24"),
    ("rwkv6-3b", "bf16:dense:hopper"),
    ("gemma3-12b", "bf16:dense:hopper"),
    ("musicgen-medium", "bf16:dense:hopper"),
    ("chameleon-34b", "bf16:dense:hopper")])
def test_launches_expected_counts_each_block_kind(smoke, monkeypatch, arch,
                                                  spec):
    check_one_step(smoke, monkeypatch, arch, spec, 64)


def test_launches_expected_counts_a_step_of_four_ce_chunks(smoke,
                                                           monkeypatch):
    """gemma3's [train-blocks] arm, B=1 at S=2048: four CE chunks, each
    checkpointed, so the head launches eight times."""
    check_one_step(smoke, monkeypatch, "gemma3-12b", "bf16:dense:hopper",
                   2048)


def check_one_step(smoke, monkeypatch, arch, spec, seq):
    """One step of reduced ``arch`` at B=1 and ``seq`` tokens, its kernel
    calls counted, against ``train_launches_expected``."""
    calls = {"A": 0, "batched": 0, "D": 0}
    real = {"A": tfm.fp8_matmul, "batched": tfm.fp8_matmul_batched,
            "D": tsm.sparse24_matmul}

    def count(*keys):
        def wrapped(*a, **k):
            for key in keys:
                calls[key] += 1
            return real[keys[-1]](*a, **k)
        return wrapped
    monkeypatch.setattr(tfm, "fp8_matmul", count("A"))
    monkeypatch.setattr(tfm, "fp8_matmul_batched", count("A", "batched"))
    monkeypatch.setattr(tsm, "sparse24_matmul", count("D"))
    cfg = dataclasses.replace(get_reduced(arch), remat="full")
    opt = adamw.AdamWConfig()
    state = ttl.init_state(init_params(cfg, torch.Generator().manual_seed(0)),
                           opt)
    step = ttl.make_train_step(cfg, opt, RuntimeCfg(),
                               policy=tex.parse_policy(spec))
    tokens = torch.randint(0, cfg.vocab_size, (1, seq))
    # an embeddings-input stack (musicgen, chameleon) reads (B, S, d) frames
    inputs = torch.randn((1, seq, cfg.d_model)) \
        if cfg.input_mode == "embeddings" else tokens
    step(state, {"inputs": inputs, "labels": tokens})
    want = smoke.train_launches_expected(cfg, spec, 1, seq)
    assert calls == {"A": want["launches"]["gemm"], "batched": want["batched"],
                     "D": want["launches"]["sparse24_gemm"]}
    assert calls["A"] + calls["D"] > 0 or spec.endswith(":torch")


def test_train_arms_keep_their_counts(smoke):
    """[train]'s llama3-8b arms: 7 linears per layer, each checkpointed
    launch twice, the head twice per CE chunk (one chunk at S=512): 114 a
    step. A bf16 linear's backward adds two (dX and dW, 112 a step over
    56 linears); fp8's backward and the head's f32 one add none."""
    cfg = smoke.train_cfg()
    got = {spec: smoke.train_launches_expected(cfg, spec, 3)
           for spec in ("bf16:dense:hopper", "fp8:dense:hopper",
                        "bf16:dense:torch", "bf16:sparse24:hopper",
                        "bf16:dense:hopper_sparse24")}
    assert got["fp8:dense:hopper"]["launches"]["gemm"] == 3 * 114 == 342
    assert got["bf16:dense:hopper"]["launches"]["gemm"] == \
        3 * (114 + 2 * 56) == 678
    assert got["bf16:sparse24:hopper"] == got["bf16:dense:hopper"]
    assert not any(got["bf16:dense:torch"]["launches"].values())
    assert got["bf16:dense:hopper_sparse24"]["launches"] == {
        "gemm": 6, "flash_attention": 0, "paged_attention": 0,
        "sparse24_gemm": 336, "block24_gemm": 0}
    assert all(g["batched"] == 0 for g in got.values())


def test_head_launches_once_per_checkpointed_ce_chunk(smoke):
    """The LM head's term at the gemma3 arm's S=2048: CE_CHUNK=512 makes
    four chunks, each checkpointed, so 8 head launches per step; 2 at
    S=512, where one chunk covers it."""
    cfg = dataclasses.replace(get_reduced("llama3-8b"), remat="none")
    got = {seq: smoke.train_launches_expected(
        cfg, "bf16:dense:hopper", 1, seq)["launches"]["gemm"]
        for seq in (512, 2048)}
    assert got[2048] - got[512] == 2 * (2048 // ttl.CE_CHUNK - 1) == 6


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "gemma3-12b",
                                  "musicgen-medium", "chameleon-34b"])
def test_train_bytes_reckons_the_state_byte_for_byte(smoke, arch, moments):
    """``train_bytes`` (the card's reckoning before a step runs, from a
    shape-only tree) against the state ``init_state`` allocates for a
    reduced init, by part, with f32 and with bf16 moments."""
    cfg = get_reduced(arch)
    opt = adamw.AdamWConfig(moments_dtype=moments)
    state = ttl.init_state(init_params(cfg, torch.Generator().manual_seed(0)),
                           opt)
    assert smoke.train_bytes(cfg, opt) == smoke.state_bytes(state)
    peak = smoke.train_peak_reckoned(cfg, opt)
    assert peak["state"] == sum(smoke.state_bytes(state).values())
    assert peak["grads"] == smoke.state_bytes(state)["params"]
