"""The serving CLI against a session built as the card's smoke test
builds it.

On the card, ``chip_smoke.py``'s ``[dense-wide]`` phase holds the tokens
that ``python -m repro_torch.launch.serve`` prints on chameleon-34b whole
to those of a session whose weights and prompts ``block_model`` and
``block_requests`` drew. Here the same correspondence is held on the
reduced config: the CLI, called in process with the card's arguments but
``--reduced --device cpu``, prints the first tokens of such a session.
(The widest dense stacks' greedy tokens are held to JAX's in
``test_torch_serve_blocks.py``.)
"""
import contextlib
import importlib.util
import io
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.core import execution as tex
from repro_torch.launch import serve as serve_cli
from repro_torch.models import init_params as t_init_params
from repro_torch.models.layers import RuntimeCfg as TRt
from repro_torch.runtime import serve_loop as tsl

from torch_train_parity import one_torch_thread  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serving_cli_prints_the_smoke_sessions_tokens(smoke):
    """The card's CLI arguments (8 prompts of 128 tokens, 4 slots,
    ``--backend hopper``) on the reduced chameleon-34b: return 0, the
    completion line ``serve_cli_check`` looks for, and for each of the
    four requests listed the first 8 tokens of a ``ServeSession`` whose
    weights are drawn as ``block_model`` draws them and whose requests
    are ``block_requests``'s."""
    argv = list(smoke.WIDE_CLI_ARGV)
    argv[argv.index("--device") + 1] = "cpu"
    argv.append("--reduced")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert serve_cli.main(argv) == 0
    out = buf.getvalue()
    n = smoke.N_REQUESTS
    assert f"[serve] {n}/{n} requests, {n * smoke.MAX_NEW} tokens" in out
    got = smoke.cli_first_tokens(out)
    assert len(got) == 4

    cfg = t_get_reduced(smoke.WIDE_CLI_ARCH)
    gen = torch.Generator(device="cpu").manual_seed(smoke.SEED)
    params = t_init_params(cfg, gen, device="cpu")
    sess = tsl.ServeSession(
        params, cfg, batch_slots=smoke.SLOTS, max_len=smoke.MAX_LEN,
        rt=TRt(use_pallas=True),
        policy=tex.parse_policy("bf16:dense:hopper"), device="cpu")
    for req in smoke.block_requests(cfg, [128] * n)():
        sess.submit(req)
    want = {r.uid: r.out for r in sess.run()}
    assert all(len(o) == smoke.MAX_NEW for o in want.values())
    assert got == {uid: want[uid][:8] for uid in got}
