"""The plain reference against the port at the port's small presets on
the CPU, both in float32: served logits, and three AdamW steps of each
block kind the cells train."""

import pytest
import torch

import small
from perfbench.harness import weights
from perfbench.reference import model as refm


def f32_tree(t):
    if isinstance(t, dict):
        return {k: f32_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [f32_tree(v) for v in t]
    return t.to(torch.float32, copy=True)


def port(conf):
    from repro_torch.core import execution as ex
    from repro_torch.models.layers import RuntimeCfg
    cfg = small.arch(conf)
    pol = ex.parse_policy("bf16:dense:torch")
    cfg, rt = ex.apply_policy(cfg, RuntimeCfg(act_dtype=torch.float32), pol)
    return cfg, rt


def test_served_rows_equal_the_port_forward():
    from repro_torch.models.transformer import forward, params_shape
    conf = small.DENSE
    cfg, rt = port(conf)
    c = refm.RefCfg.from_config(conf)
    params, _ = weights.make(params_shape(cfg), 7, torch.device("cpu"))
    p32 = f32_tree(params)
    gen = torch.Generator().manual_seed(0)
    seqs = [(torch.randint(0, c.vocab, (n,), generator=gen).tolist(),
             torch.randint(0, c.vocab, (m,), generator=gen).tolist())
            for n, m in ((9, 5), (20, 7))]
    rows = refm.served_rows(p32, c, seqs)
    for (p, o), r in zip(seqs, rows):
        ids = torch.as_tensor(p + o[:-1])[None]
        with torch.no_grad():
            logits, _ = forward(p32, ids, cfg, rt)
        want = logits[0, len(p) - 1:, :c.vocab]
        assert torch.allclose(r, want, atol=2e-5, rtol=1e-5)
        assert float(refm.gaps(r, want.argmax(-1).tolist()).max()) == 0.0


@pytest.mark.parametrize("which", ["dense", "moe"])
def test_three_steps_equal_the_port_train_step(which):
    from repro_torch.core import tree
    from repro_torch.models.transformer import params_shape
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop as tl
    conf = small.MOE if which == "moe" else dict(small.DENSE,
                                                   input="embeddings")
    mix = small.mix("train", **small.TRAIN)
    ctx = small.ctx("x", 11, 1.0, torch.device("cpu"), conf, mix, {})
    cfg, rt = port(conf)
    shape = params_shape(cfg)
    params, _ = weights.make(shape, 11, torch.device("cpu"))
    o = mix["optimizer"]
    opt = adamw.AdamWConfig(
        learning_rate=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
        weight_decay=o["weight_decay"], warmup_steps=o["warmup_steps"],
        total_steps=o["total_steps"], grad_clip=o["grad_clip"])
    state = tl.init_state(f32_tree(params), opt)
    step = tl.make_train_step(cfg, opt, rt)
    from perfbench.drivers.train import batch_maker
    batch = batch_maker(ctx)
    losses = []
    for i in (1, 2, 3):
        state, m = step(state, batch(i))
        losses.append(float(m["loss"]))
    flat = [t.to(torch.float32, copy=True) for t in refm.leaves_of(params)]
    ref = refm.AdamW(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                     weight_decay=o["weight_decay"], warmup=o["warmup_steps"],
                     total=o["total_steps"], clip=o["grad_clip"])
    r_losses = refm.train_steps(flat, lambda fl: refm.rebuild(shape, fl),
                                [batch(i) for i in (1, 2, 3)], ctx.ref, ref,
                                refm.decay_flags(shape))
    assert losses == pytest.approx(r_losses, rel=1e-5)
    for a, b in zip(tree.leaves(state.opt.master), flat):
        assert torch.allclose(a, b, atol=1e-6, rtol=1e-5)
