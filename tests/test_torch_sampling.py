"""The port's sampled decode against ``jax.random`` and the JAX package's
sampled sessions, on the CPU.

``repro_torch.core.prng`` reproduces threefry2x32 as JAX runs it
(partitionable): keys, splits, 32-bit bits and uniforms are bit-equal to
``jax.random``'s; Gumbel noise differs by the last bits of ``log`` (under
2e-6 absolute), so a categorical draw equals JAX's wherever its two best
perturbed logits lie further apart than that. The sessions (reduced
llama3-8b in f32 from one bridged init) then emit JAX's sampled token
streams exactly: dense, paged, across a slot handoff and through the
multi-tenant runtime with migration on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import serve_loop as jsl
from repro.runtime import server as jsv
from repro_torch.core import prng
from repro_torch.runtime import serve_loop as tsl
from repro_torch.runtime import server as tsv
from torch_runtime_parity import CFG, JRT, MAX_LEN, TRT, outs, params

SHAPES = [(7,), (4, 512), (3, 5, 11), (4, 128256)]
GUMBEL_TOL = 2e-6
SAMPLED = [(0.5, 0), (0.7, 3)]     # (temperature, seed)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jkey(key):
    return jnp.asarray(key, jnp.uint32)


@pytest.mark.parametrize("seed", [0, 1, 3, 2**31 + 5])
def test_prng_key_matches_jax(seed):
    want = np.asarray(jax.random.PRNGKey(seed))
    got = prng.PRNGKey(seed)
    assert got.dtype == np.uint32 and np.array_equal(got, want)


def test_a_chain_of_splits_matches_jax():
    jkey, key = jax.random.PRNGKey(7), prng.PRNGKey(7)
    for _ in range(50):
        jkey, jsub = jax.random.split(jkey)
        key, sub = prng.split(key)
        assert np.array_equal(key, np.asarray(jkey))
        assert np.array_equal(sub, np.asarray(jsub))
    assert np.array_equal(prng.split(key, 5),
                          np.asarray(jax.random.split(jkey, 5)))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_are_bit_equal_to_jax(shape):
    key = prng.split(prng.PRNGKey(11))[1]
    bits = np.asarray(jax.random.bits(_jkey(key), shape, jnp.uint32))
    got = prng.random_bits(key, shape)
    assert got.shape == shape
    assert np.array_equal(got.numpy(), bits.astype(np.int64))
    uni = np.asarray(jax.random.uniform(_jkey(key), shape))
    got = prng.uniform(key, shape).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), uni.view(np.int32))
    # Gumbel's range
    tiny = np.finfo(np.float32).tiny
    uni = np.asarray(jax.random.uniform(_jkey(key), shape, minval=tiny))
    got = prng.uniform(key, shape, minval=tiny).numpy()
    assert np.array_equal(got.view(np.int32), uni.view(np.int32))


@pytest.mark.parametrize("shape", [(4, 512), (4, 128256)])
def test_gumbel_within_the_last_bits_of_log(shape):
    key = prng.PRNGKey(5)
    want = np.asarray(jax.random.gumbel(_jkey(key), shape))
    got = prng.gumbel(key, shape).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= GUMBEL_TOL


def test_categorical_is_jax_token_past_near_ties():
    logits = np.random.default_rng(0).normal(
        size=(64, 1000)).astype(np.float32) * 3
    key = prng.PRNGKey(2)
    want = np.asarray(jax.random.categorical(_jkey(key), logits))
    got = prng.categorical(key, torch.from_numpy(logits)).numpy()
    pert = logits + np.asarray(jax.random.gumbel(_jkey(key), logits.shape))
    top2 = np.sort(pert, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-5
    assert clear.sum() >= 60
    assert np.array_equal(got[clear], want[clear])


def test_the_reference_step_scales_by_the_reciprocal():
    """Why the port's step multiplies: XLA compiles the reference's jitted
    ``logits / temperature`` (a constant) into a product with the f32
    reciprocal, while the reference's admission divides op by op."""
    x = np.random.default_rng(1).normal(size=(4, 1000)).astype(np.float32)
    t = 0.7
    jitted = np.asarray(jax.jit(lambda v: v / t)(x))
    eager = np.asarray(jnp.asarray(x) / t)
    assert np.array_equal(jitted, x * (np.float32(1) / np.float32(t)))
    assert np.array_equal(eager, x / np.float32(t))
    assert not np.array_equal(jitted, eager)


# -- sessions -----------------------------------------------------------------

SLOTS = 2
PROMPT_LENS = (5, 9, 9, 5, 5, 9)


def _requests(seed=0, max_new=6):
    """Six requests of mixed lengths, so admissions interleave with decode
    (as (JAX Requests, port Requests))."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    return tuple([mod.Request(uid=i, prompt=p.copy(), max_new=max_new + i % 3)
                  for i, p in enumerate(prompts)] for mod in (jsl, tsl))


def _sessions(temperature, seed, **kw):
    jp, tp = params()
    return (jsl.ServeSession(jp, CFG, batch_slots=SLOTS, max_len=MAX_LEN,
                             rt=JRT, temperature=temperature, seed=seed, **kw),
            tsl.ServeSession(tp, CFG, batch_slots=SLOTS, max_len=MAX_LEN,
                             rt=TRT, temperature=temperature, seed=seed,
                             device="cpu", **kw))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("temperature,seed", SAMPLED)
def test_sampled_session_stream_equals_jax(temperature, seed, paged):
    kw = dict(paged=True, page_size=8) if paged else {}
    got = []
    for sess, reqs in zip(_sessions(temperature, seed, **kw), _requests()):
        for r in reqs:
            sess.submit(r)
        sess.run()
        assert all(r.done for r in reqs)
        got.append((outs(reqs), [int(w) for w in np.asarray(sess.rng)]))
    assert got[0] == got[1]
    greedy = _sessions(0.0, seed, **kw)[1]
    reqs = _requests()[1]
    for r in reqs:
        greedy.submit(r)
    greedy.run()
    assert outs(reqs) != got[1][0]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_sampled_handoff_continues_on_the_importer_chain(paged):
    """Two requests decode two steps on one session; one is exported and
    imported into a session of another seed, where it goes on sampling
    beside a request of that session's own."""
    kw = dict(paged=True, page_size=8) if paged else {}
    got = []
    for k in (0, 1):
        src = _sessions(0.7, 1, **kw)[k]
        dst = _sessions(0.7, 4, **kw)[k]
        reqs = _requests(seed=2, max_new=8)[k]
        src.admit(reqs[0])
        src.admit(reqs[1])
        src.decode_once()
        src.decode_once()
        export = src.export_slot(1)
        dst.admit(reqs[2])
        dst.import_slot(export)
        src.run()
        dst.run()
        assert all(r.done for r in reqs[:3])
        got.append(outs(reqs[:3]))
    assert got[0] == got[1]


def test_sampled_runtime_with_migration_equals_jax():
    """``ServingSpec(temperature=0.5, seed=3)`` over two partitions with
    migration on and a forced migrate mid-request: every partition's
    session samples from the spec's seed."""
    jp, tp = params()
    got = []
    for k, (mod, p, kw) in enumerate(((jsv, jp, dict(rt=JRT)),
                                      (tsv, tp, dict(rt=TRT,
                                                     device="cpu")))):
        spec = mod.ServingSpec(
            partitions=(mod.PartitionSpec(policy="bf16:dense:jnp"),) * 2,
            placement="spread", batch_slots=SLOTS, max_len=MAX_LEN,
            temperature=0.5, seed=3,
            migration=mod.MigrationSpec(enabled=True, interval=4,
                                        threshold=2.0, cooldown=8))
        rt = mod.ServingRuntime(p, CFG, spec, **kw)
        rt.add_tenant("mover", partition=0)
        rt.add_tenant("stay", partition=1)
        mover, stay = _requests(seed=5)[k][:3], _requests(seed=6)[k][3:]
        for r in mover:
            rt.submit("mover", r)
        for r in stay:
            rt.submit("stay", r)
        for _ in range(3):
            rt.step()
        rt.migrate("mover", 1)
        rt.drain()
        assert all(r.done for r in mover + stay)
        got.append((outs(mover), outs(stay),
                    [m.to_dict() for m in rt.migrations]))
    assert got[0] == got[1]
    assert got[1][2]


def test_serve_cli_samples_deterministically_in_its_seed(capsys):
    from repro_torch.launch import serve

    def served(*args):
        assert serve.main(["--arch", "llama3-8b", "--reduced", "--device",
                           "cpu", "--requests", "3", "--max-new", "5",
                           *args]) == 0
        out = capsys.readouterr().out
        assert "[serve] 3/3 requests" in out
        return [ln for ln in out.splitlines() if ln.startswith("  req ")]

    sampled = served("--temperature", "0.7", "--seed", "1")
    assert served("--temperature", "0.7", "--seed", "1") == sampled
    assert served("--seed", "1") != sampled
