"""The split plan of kernel C (``repro_torch.kernels.paged_attention``):
the splits depend on the shape alone, cover every position of the page
table once in whole chunks, fill the card where the table has the chunks
for it, and folding per-split partials (m, l, acc) in split order gives
the kernel's plain result.

Runs on the CPU: the plan is plain Python, and the fold is what the CUDA
kernel's last block computes. Inputs come from numpy seeds.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as pa

H100_SMS = 132

# (batch, kv_heads, max_pos): llama3-8b's serving and sweep tables (4 slots
# x 8 kv heads x 512 positions), one slot, long tables, the JAX test's
# geometry and ragged tables that are not a whole number of chunks
KEYS = [(4, 8, 512, H100_SMS), (1, 8, 512, H100_SMS), (4, 8, 4096, H100_SMS),
        (64, 8, 2048, H100_SMS), (3, 2, 32, H100_SMS), (5, 8, 144, H100_SMS),
        (2, 2, 40, H100_SMS), (4, 8, 520, H100_SMS), (1, 1, 1, H100_SMS),
        (4, 8, 512, 16), (8, 1, 100000, H100_SMS)]


@pytest.mark.parametrize("B,kvh,max_pos,sms", KEYS)
def test_splits_cover_every_position_once_in_whole_chunks(B, kvh, max_pos,
                                                          sms):
    p = pa.split_plan(B, kvh, max_pos, sms)
    ranges = p.ranges(max_pos)
    assert len(ranges) == p.splits >= 1
    cover = np.zeros(max_pos, dtype=np.int64)
    for p0, p1 in ranges:
        assert p0 < p1, "no split is empty of table positions"
        assert p0 % pa.CHUNK == 0 and p0 % p.span == 0
        assert p1 == max_pos or p1 - p0 == p.span
        cover[p0:p1] += 1
    assert (cover == 1).all()
    assert p.span % pa.CHUNK == 0 and p.splits * p.span >= max_pos


@pytest.mark.parametrize("B,kvh,max_pos,sms", KEYS)
def test_plan_fills_the_card_where_the_table_allows(B, kvh, max_pos, sms):
    p = pa.split_plan(B, kvh, max_pos, sms)
    target = int(pa.BLOCKS_PER_SM * sms)
    chunks = -(-max_pos // pa.CHUNK)
    if B * kvh >= target:
        assert p.splits == 1
    else:
        assert p.splits <= chunks
        assert B * kvh * p.splits >= min(target, B * kvh * chunks) // 2
        assert B * kvh * (p.splits - 1) < target


def test_serving_shape_gets_eight_splits_of_two_chunks():
    """4 slots x 8 kv heads x 512 positions: 256 blocks on 132 SMs."""
    p = pa.split_plan(4, 8, 512, H100_SMS)
    assert (p.splits, p.span) == (8, 64)
    assert "256 blocks" in p.describe(4, 8)


def test_plan_is_a_pure_function_of_its_key():
    pa.split_plan.cache_clear()
    first = {key: pa.split_plan(*key) for key in KEYS}
    again = {key: pa.split_plan(*key) for key in KEYS}
    pa.split_plan.cache_clear()
    fresh = {key: pa.split_plan(*key) for key in KEYS}
    assert first == again == fresh
    assert all(first[key] is again[key] for key in KEYS)


def test_plan_refuses_what_it_cannot_plan():
    for bad in ((0, 8, 512, H100_SMS), (4, 0, 512, H100_SMS),
                (4, 8, 0, H100_SMS), (4, 8, 512, 0)):
        with pytest.raises(ValueError):
            pa.split_plan(*bad)


def test_launch_plan_refuses_the_cpu():
    """The workspace, counters and SM count belong to a CUDA device."""
    with pytest.raises((AssertionError, RuntimeError, ValueError)):
        pa.launch_plan(4, 32, 8, 128, 512, torch.device("cpu"))


def _inputs(B, h, kvh, hd, ps, mp, lengths, seed, hole=False):
    rng = np.random.default_rng(seed)
    pool = B * mp + 1
    q = torch.from_numpy(rng.normal(size=(B, h, hd)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=(pool, ps, kvh, hd))
                          .astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(pool, ps, kvh, hd))
                          .astype(np.float32))
    pm = rng.permutation(pool - 1)[:B * mp].reshape(B, mp).astype(np.int32)
    if hole:
        pm[0, mp // 2] = -1
    return (q, kp, vp, torch.from_numpy(pm),
            torch.tensor(lengths, dtype=torch.int32))


def _split_fold(q, kp, vp, pm, ln, plan):
    """Each split's partial over its positions (masked as the kernel masks
    them: past the length, or on a page of -1), folded in split order as
    the kernel's last block folds them."""
    B, h, hd = q.shape
    _, ps, kvh, _ = kp.shape
    max_pos = pm.shape[1] * ps
    s, v, valid = pa._gather(q, kp, vp, pm, ln)      # (B, kvh, G, S)
    parts = []
    for p0, p1 in plan.ranges(max_pos):
        ok = valid[:, None, None, p0:p1]
        sz = torch.where(ok, s[..., p0:p1], torch.full_like(s[..., p0:p1],
                                                            pa.NEG_INF))
        m = sz.amax(dim=-1, keepdim=True)
        e = torch.exp(sz - m) * ok
        acc = torch.einsum("bkgs,bskd->bkgd", e, v[:, p0:p1])
        parts.append((m, e.sum(dim=-1, keepdim=True), acc))
    mt = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    lt = torch.zeros_like(mt)
    out = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(l > 0, torch.exp(m - mt), torch.zeros_like(m))
        lt = lt + l * w
        out = out + acc * w
    return (out / lt.clamp_min(1e-30)).reshape(B, h, hd)


@pytest.mark.parametrize("B,h,kvh,hd,ps,mp,lengths,hole", [
    (4, 32, 8, 16, 16, 32, (129, 78, 1, 0), False),
    (4, 32, 8, 16, 8, 64, (512, 512, 512, 512), False),
    (4, 32, 8, 16, 16, 32, (64, 128, 200, 0), True),
    (3, 4, 2, 16, 8, 4, (13, 32, 1), False),
    (2, 32, 2, 32, 12, 20, (240, 37), True),
])
def test_split_fold_matches_the_plain_version(B, h, kvh, hd, ps, mp,
                                              lengths, hole):
    """Within JAX's own f32 tolerance (2e-5); rows with no valid position
    come out exactly 0, and the fold repeats bit for bit."""
    args = _inputs(B, h, kvh, hd, ps, mp, lengths, seed=B * 31 + ps,
                   hole=hole)
    plan = pa.split_plan(B, kvh, mp * ps, H100_SMS)
    got = _split_fold(*args, plan)
    want = pa.paged_flash_decode_plain(*args)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert torch.equal(got, _split_fold(*args, plan))
    empty = torch.tensor([n == 0 for n in lengths])
    assert (got[empty] == 0).all() and (want[empty] == 0).all()
