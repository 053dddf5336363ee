"""The port's copy of the page allocator and of the block-shape cache
against the JAX package's.

One seeded sequence of allocator calls (alloc, extend, free, trim, import,
exhaustion included) goes through ``repro.core.paging.PageAllocator`` and
``repro_torch.core.paging.PageAllocator``: every call returns the same page
ids or raises ``PagesExhausted`` at the same point, and the tables, stats
and ``page_map`` agree after each call.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import execution as jex
from repro.core import paging as jpg
from repro_torch.core import execution as tex
from repro_torch.core import paging as tpg


def _call(alloc, exc, op, *args):
    try:
        return ("ok", getattr(alloc, op)(*args))
    except exc as e:
        return ("refused", type(e).__name__)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_sequence_matches_jax(seed):
    geo = dict(n_pages=12, page_size=4, max_pages_per_slot=5, n_slots=4)
    ja, ta = jpg.PageAllocator(**geo), tpg.PageAllocator(**geo)
    rng = np.random.default_rng(seed)
    refusals = 0
    for _ in range(200):
        slot = int(rng.integers(0, geo["n_slots"]))
        held = ja.slot_pages(slot)
        tokens = int(rng.integers(1, 24))
        if not held:
            op, args = (("import_slot", (slot, int(rng.integers(1, 5)),
                                         tokens))
                        if rng.random() < 0.2 else ("alloc_slot",
                                                    (slot, tokens)))
        else:
            op = rng.choice(["extend_slot", "free_slot", "trim_slot",
                             "note_tokens"])
            args = (slot,) if op == "free_slot" else (slot, tokens)
        want = _call(ja, (jpg.PagesExhausted, ValueError), op, *args)
        got = _call(ta, (tpg.PagesExhausted, ValueError), op, *args)
        assert got == want, (op, args)
        refusals += want[0] == "refused"
        np.testing.assert_array_equal(ta.page_map(), ja.page_map())
        assert ta.stats() == ja.stats()
        assert ta.can_admit_tokens(tokens) == ja.can_admit_tokens(tokens)
    assert refusals > 0 and ja.stats()["oom_refusals"] > 0


def test_free_list_is_lifo():
    a = tpg.PageAllocator(4, 4, 4, 2)
    pages = a.alloc_slot(0, 16)
    a.free_slot(0)
    assert a.alloc_slot(1, 16) == pages


def test_pages_for_and_state_blocks_match_jax():
    from repro.configs import get_reduced
    for n, ps in ((0, 4), (1, 4), (5, 4), (16, 16), (17, 16)):
        assert tpg.pages_for(n, ps) == jpg.pages_for(n, ps)
    for arch in ("llama3-8b", "zamba2-1.2b", "rwkv6-3b"):
        cfg = get_reduced(arch)
        assert tpg.state_block_tokens(cfg) == jpg.state_block_tokens(cfg)


def test_record_is_a_no_op_without_a_tracer():
    a = tpg.PageAllocator(4, 4, 4, 2)
    a.record(None, phase="admit")

    class Tracer:
        events = []

        def record(self, kind, **kw):
            self.events.append((kind, kw))

    tr = Tracer()
    a.record(tr, phase="admit", slot=1)
    assert tr.events[0][0] == "paging"
    assert tr.events[0][1]["meta"]["slot"] == 1


_DT = {"bf16": (jnp.bfloat16, torch.bfloat16),
       "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
       "fp32": (jnp.float32, torch.float32)}


def test_block_cache_lookups_match_jax():
    jc, tc = jex.BlockShapeCache(), tex.BlockShapeCache()
    assert tc.entries() == jc.entries()
    shapes = [(4, 4096, 14336), (128, 128, 128), (256, 256, 128),
              (7, 512, 3), (4, 128, 512)]
    for prec, (jd, td) in _DT.items():
        for m, k, n in shapes:
            assert tc.lookup(m, k, n, td) == jc.lookup(m, k, n, jd)
            assert tc.lookup(m, k, n, prec) == jc.lookup(m, k, n, prec)
    for secs, ps in ((3e-5, 8), (1e-5, 16), (2e-5, 32)):
        jc.record(4, 128, 512, jnp.bfloat16, (1, ps, 128), secs)
        tc.record(4, 128, 512, torch.bfloat16, (1, ps, 128), secs)
    assert tc.lookup(4, 128, 512, "bf16") == (1, 16, 128)
    assert tc.entries() == jc.entries() and len(tc) == len(jc)
    for prec, (jd, td) in _DT.items():
        for m, k, n in shapes:
            assert tc.lookup(m, k, n, td) == jc.lookup(m, k, n, jd)


@pytest.mark.parametrize("name", [
    "pagedsweep/bf16/4x512x128/1x16x128",
    "pagedsweep/fp8/2x32x16/1x8x16",
    "pagedsweep/fp32/1x2x3/4x5x6",
    "pagedsweep/int8/4x512x128/1x16x128",
    "blocksweep/bf16/4x512x128/1x16x128",
    "pagedsweep/bf16/4x512/1x16x128",
    "pagedsweep/bf16/4x512x128/1x16",
    "pagedsweep/bf16/axbxc/1x16x128",
    "pagedsweep/bf16/4x512x128",
])
def test_parse_pagedsweep_name_matches_jax(name):
    assert tex.parse_pagedsweep_name(name) == jex.parse_pagedsweep_name(name)
