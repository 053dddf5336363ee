"""The launch plan of the tile GEMM (``repro_torch.kernels.gemm_plan``):
tiles cover the output once, K splits are whole BK steps, the plan is a
pure function of its key, and summing the plain partial products over the
plan's K ranges in split order gives the kernel's plain result.

Runs on the CPU: the plan is plain Python, and the split-order sum is what
the CUDA kernels' split-K fix-up computes. Inputs come from numpy seeds.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fp8_matmul as fm
from repro_torch.kernels import gemm_plan as gp

H100_SMS = 132

# llama3-8b's projections at decode (M = 4 slots) and prefill (128, 77),
# the LM head, and ragged shapes
MAIN_PATH = [(M, K, N) for M in (4, 128, 77)
             for K, N in ((4096, 14336), (4096, 4096), (4096, 1024),
                          (14336, 4096))] + [(4, 4096, 128256)]
RAGGED = [(77, 4000, 1000), (33, 200, 72), (3, 24, 40), (5, 8, 3),
          (128, 4100, 1030), (17, 4096, 1024)]
SMALL_M = [(m, k, n) for m in (1, 2, 3, 4) for k, n in ((4096, 1024),
                                                        (64, 8), (8, 3))]
SHAPES = MAIN_PATH + RAGGED + SMALL_M


@pytest.mark.parametrize("kind", gp.KINDS)
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_every_output_tile_appears_once_and_splits_partition_k(M, K, N,
                                                               kind):
    p = gp.plan(M, N, K, kind, H100_SMS)
    assert (p.bm, p.bn, p.bk) == gp.TILES[p.tile]
    assert p.tile == (gp.SMALL if M <= 16 else gp.PREFILL_TILE[kind])
    cover = np.zeros((M, N), dtype=np.int64)
    for mt in range(p.m_tiles):
        for nt in range(p.n_tiles):
            cover[mt * p.bm:(mt + 1) * p.bm, nt * p.bn:(nt + 1) * p.bn] += 1
    assert (cover == 1).all()
    assert (p.m_tiles - 1) * p.bm < M and (p.n_tiles - 1) * p.bn < N
    ranges = p.k_ranges(K)
    assert len(ranges) == p.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    for k0, k1 in ranges:
        assert k0 % p.bk == 0 and k0 < k1 or K == 0
        assert k1 == K or (k1 - k0) == p.steps_per_split * p.bk


@pytest.mark.parametrize("M,K,N", MAIN_PATH)
def test_plan_fills_the_card_where_k_allows(M, K, N):
    """Decode shapes reach the block count their kind asks for; the LM head
    fills it with tiles alone and takes no split."""
    for kind in gp.KINDS:
        p = gp.plan(M, N, K, kind, H100_SMS)
        target = int(gp.BLOCKS_PER_SM[kind, p.tile] * H100_SMS)
        steps = -(-K // p.bk)
        tiles = p.m_tiles * p.n_tiles
        if tiles >= target:
            assert p.splits == 1
        else:
            assert p.blocks >= min(target, tiles * steps) * 0.9
    assert gp.plan(4, 128256, 4096, "gemm", H100_SMS).splits == 1


def test_plan_is_a_pure_function_of_its_key():
    gp.plan.cache_clear()
    first = {s: gp.plan(s[0], s[2], s[1], "gemm", H100_SMS) for s in SHAPES}
    again = {s: gp.plan(s[0], s[2], s[1], "gemm", H100_SMS) for s in SHAPES}
    gp.plan.cache_clear()
    fresh = {s: gp.plan(s[0], s[2], s[1], "gemm", H100_SMS) for s in SHAPES}
    assert first == again == fresh
    assert all(first[s] is again[s] for s in SHAPES)


def test_plan_refuses_what_it_cannot_plan():
    with pytest.raises(ValueError):
        gp.plan(4, 64, 64, "conv", H100_SMS)
    with pytest.raises(ValueError):
        gp.plan(0, 64, 64, "gemm", H100_SMS)


@pytest.mark.parametrize("M,K,N", [(4, 4096, 64), (4, 4096, 1024),
                                   (3, 1000, 72), (128, 4096, 256),
                                   (77, 4000, 130)])
def test_split_order_sum_equals_the_plain_product(M, K, N):
    """The fix-up's sum of f32 partials over the plan's K ranges, split 0
    first, against ``fp8_matmul_plain``: within f32 rounding, and exactly
    repeatable."""
    rng = np.random.default_rng(M * 7 + N)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(K, N)) * K ** -0.5)
                         .astype(np.float32))
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    p = gp.plan(M, N, K, "gemm", H100_SMS)
    assert p.splits > 1

    def split_sum():
        acc = torch.zeros((M, N), dtype=torch.float32)
        for k0, k1 in p.k_ranges(K):
            acc = acc + fm.fp8_matmul_plain(x[:, k0:k1], w[k0:k1])
        return acc

    got = split_sum()
    want = fm.fp8_matmul_plain(x, w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, split_sum())


def test_launch_plan_refuses_the_cpu():
    """The scratch and SM count belong to a CUDA device."""
    with pytest.raises((AssertionError, RuntimeError, ValueError)):
        gp.launch_plan(4, 64, 64, "gemm", torch.device("cpu"))


@pytest.mark.parametrize("M,tile,splits,blocks", [
    (4, gp.SMALL, 1, 224), (128, gp.DEEP, 1, 112), (77, gp.DEEP, 1, 112)])
def test_kernel_e_has_its_own_schedule(M, tile, splits, blocks):
    """Kernel E at llama3-8b's gate/up shape (K/2 = 2048 packed rows):
    decode unsplit on the Small tile, prefill on the deep-ring tile; A and D
    keep theirs at the same shapes."""
    p = gp.plan(M, 14336, 2048, "block24", H100_SMS)
    assert (p.tile, p.splits, p.blocks) == (tile, splits, blocks)
    for kind in ("gemm", "sparse24"):
        assert gp.plan(M, 14336, 2048, kind, H100_SMS).tile in (gp.SMALL,
                                                                gp.WIDE)


def test_split_scratch_belongs_to_the_stream():
    """One set per (device, stream): the same stream gets its set back,
    grown to the largest request; another stream, or the same handle on
    another device, gets a set of its own."""
    table = gp.StreamScratch()
    cpu = torch.device("cpu")
    a = table.get(cpu, 7, 100, 4)
    assert table.get(cpu, 7, 10, 2) is a
    assert a.ws.numel() == 100 and a.counters.numel() == 4
    assert (a.counters == 0).all()
    grown = table.get(cpu, 7, 300, 8)
    assert grown is a and a.ws.numel() == 300 and a.counters.numel() == 8
    b = table.get(cpu, 8, 100, 4)
    assert b is not a and b.ws.data_ptr() != a.ws.data_ptr()
    assert table.get(torch.device("meta"), 7, 1, 1) is not a


# granite-moe-3b-a800m's expert GEMMs (40 experts, d 1536, expert d_ff 512)
# at a 4-slot decode step (capacity 1) and a 128-token prefill (32), and a
# batch of two whose tiles alone do not fill the card
EXPERT_SHAPES = [(40, 1, 1536, 512), (40, 1, 512, 1536), (40, 32, 1536, 512),
                 (40, 32, 512, 1536), (2, 4, 4096, 1024)]


@pytest.mark.parametrize("E,M,K,N", EXPERT_SHAPES)
def test_batched_plan_counts_every_member(E, M, K, N):
    """A batched launch gives each member the tile and splits a launch of
    that size would take, counting every member's tiles toward the card:
    the granite shapes fill it without a split (320, 960, 160 and 480
    blocks), and a batch of two still splits K."""
    p = gp.plan(M, N, K, "gemm", H100_SMS, E)
    alone = gp.plan(M, N, K, "gemm", H100_SMS)
    assert (p.tile, p.m_tiles, p.n_tiles, p.batch) == \
        (alone.tile, alone.m_tiles, alone.n_tiles, E)
    target = int(gp.BLOCKS_PER_SM["gemm", p.tile] * H100_SMS)
    tiles = p.m_tiles * p.n_tiles * E
    assert p.blocks == tiles * p.splits
    if tiles >= target:
        assert p.splits == 1
    else:
        assert 1 < p.splits <= alone.splits
    assert f"x {E} members" in p.describe()
    assert gp.plan(M, N, K, "gemm", H100_SMS, 1) == alone
