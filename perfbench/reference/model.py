"""The plain reference: the decoder as the configuration file states it,
in float32 PyTorch, with no kernel, cache or batching of the program.

It reads the benchmark's weights by their names (``embed``, ``head``,
``final_norm``, ``layers[i]`` with ``norm1``, ``attn`` {``w_q``, ``w_k``,
``w_v``, ``w_o``}, ``norm2`` and ``mlp`` {``w_gate``, ``w_up``,
``w_down``} or ``moe`` {``router``, ``w_gate``, ``w_up``, ``w_down``}) and
works everything else out again. The block: pre-norm RMSNorm scaled by
``1 + gamma``; rotary embedding on split halves; causal grouped-query
attention; a SwiGLU MLP, or top-k routed SwiGLU experts with a capacity per
group of tokens (earlier choices first, then token order; a token past an
expert's capacity gets nothing from it) and the switch load-balance loss;
a final norm and an untied head. It imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_CHUNK = 512


@dataclasses.dataclass(frozen=True)
class RefCfg:
    layers: int
    d: int
    ff: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    rope_theta: float
    eps: float
    experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    group: int = 1024
    aux_weight: float = 0.01

    @classmethod
    def from_config(cls, conf: Dict) -> "RefCfg":
        """From a configuration file, its cuts applied."""
        v = {k: conf[k] for k in conf if not isinstance(conf[k], (dict,
                                                                  list))}
        for key, cut in conf.get("reduced", {}).items():
            v[key] = cut["value"]
        moe = conf.get("moe", {})
        return cls(layers=v["num_hidden_layers"], d=v["hidden_size"],
                   ff=v["intermediate_size"], heads=v["num_attention_heads"],
                   kv_heads=v["num_key_value_heads"], head_dim=v["head_dim"],
                   vocab=v["vocab_size"], rope_theta=float(v["rope_theta"]),
                   eps=float(v["rms_norm_eps"]),
                   experts=v.get("num_local_experts", 0),
                   top_k=v.get("num_experts_per_tok", 0),
                   capacity_factor=moe.get("capacity_factor", 1.25),
                   group=moe.get("group_tokens", 1024),
                   aux_weight=moe.get("aux_loss_weight", 0.01))


def rms_norm(x, gamma, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * (1.0 + gamma)


def rope(x, theta):
    """x (B, S, h, hd) at positions 0..S-1; the halves rotate."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def attention(h, p, c: RefCfg):
    b, s, _ = h.shape
    q = rope((h @ p["w_q"]).view(b, s, c.heads, c.head_dim), c.rope_theta)
    k = rope((h @ p["w_k"]).view(b, s, c.kv_heads, c.head_dim),
             c.rope_theta)
    v = (h @ p["w_v"]).view(b, s, c.kv_heads, c.head_dim)
    g = c.heads // c.kv_heads
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)      # (B, h, S, hd)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    outs = []
    for lo in range(0, s, Q_CHUNK):
        hi = min(lo + Q_CHUNK, s)
        sc = (q[:, :, lo:hi] @ k[:, :, :hi].transpose(-1, -2)) \
            / math.sqrt(c.head_dim)
        mask = torch.arange(lo, hi, device=h.device)[:, None] \
            >= torch.arange(hi, device=h.device)[None, :]
        sc = sc.masked_fill(~mask, float("-inf"))
        outs.append(torch.softmax(sc, dim=-1) @ v[:, :, :hi])
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, -1)
    return o @ p["w_o"]


def swiglu(h, p):
    return (F.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"]


def moe(h, p, c: RefCfg):
    """Routed experts over groups of ``min(group, B*S)`` tokens: (out,
    load-balance loss)."""
    b, s, d = h.shape
    t = b * s
    gs = min(c.group, t)
    if t % gs:
        raise ValueError(f"{t} tokens are no multiple of the group {gs}")
    ng, e, k = t // gs, c.experts, c.top_k
    cap = max(1, math.ceil(gs * k * c.capacity_factor / e))
    x = h.reshape(ng, gs, d)
    gates = torch.softmax(x @ p["router"], dim=-1)          # (G, gs, E)
    topv, topi = torch.topk(gates, k, dim=-1)
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    chosen = F.one_hot(topi, e).float()                     # (G, gs, k, E)
    # an expert's slots go to first choices in token order, then seconds
    order = chosen.transpose(1, 2).reshape(ng, k * gs, e)
    slot = (torch.cumsum(order, 1) - order).reshape(ng, k, gs, e) \
        .transpose(1, 2)                                    # (G, gs, k, E)
    kept = chosen * (slot < cap)
    where = F.one_hot(slot.long().clamp_max(cap - 1), cap).float() \
        * kept[..., None]                                   # (G,gs,k,E,C)
    dispatch = where.sum(2)                                 # (G, gs, E, C)
    combine = (where * topv[..., None, None]).sum(2)
    xin = torch.einsum("gsec,gsd->gecd", dispatch, x)
    hid = F.silu(torch.einsum("gecd,edf->gecf", xin, p["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", xin, p["w_up"])
    out = torch.einsum("gecf,efd->gecd", hid, p["w_down"])
    y = torch.einsum("gsec,gecd->gsd", combine, out).reshape(b, s, d)
    frac = chosen.sum(2).mean(1) / k                         # (G, E)
    aux = (frac * gates.mean(1)).sum(-1).mean() * e
    return y, aux


def block(x, lp, c: RefCfg):
    h = rms_norm(x, lp["norm1"], c.eps)
    x = x + attention(h, lp["attn"], c)
    h = rms_norm(x, lp["norm2"], c.eps)
    if c.experts:
        o, aux = moe(h, lp["moe"], c)
    else:
        o, aux = swiglu(h, lp["mlp"]), x.new_zeros(())
    return x + o, aux


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


# ---------------------------------------------------------------------------
# Serving: teacher-forced logits of served tokens
# ---------------------------------------------------------------------------

@torch.no_grad()
def served_rows(params, c: RefCfg,
                seqs: Sequence[Tuple[Sequence[int], Sequence[int]]]
                ) -> List[torch.Tensor]:
    """For each (prompt, served tokens): the float32 logits over the
    vocabulary at every position that predicted a served token, (n, V).
    One pass over the layers, each layer's weights cast to float32 once."""
    dev = params["embed"].device
    ids = [torch.as_tensor(list(p) + list(o[:-1]), dtype=torch.long,
                           device=dev) for p, o in seqs]
    xs = [params["embed"][i].float()[None] for i in ids]
    for lp in params["layers"]:
        lp32 = _f32(lp)
        xs = [block(x, lp32, c)[0] for x in xs]
        del lp32
    head = params["head"][:, :c.vocab].float()
    rows = []
    for (p, o), x in zip(seqs, xs):
        h = rms_norm(x[0, len(p) - 1:], params["final_norm"].float(), c.eps)
        rows.append(h @ head)
    return rows


def gaps(rows: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """How far below the row's best logit each token's logit lies."""
    t = torch.as_tensor(list(tokens), dtype=torch.long, device=rows.device)
    return rows.max(-1).values - rows.gather(1, t[:, None])[:, 0]


# ---------------------------------------------------------------------------
# Training: loss, gradients and AdamW in float32
# ---------------------------------------------------------------------------

def loss_fn(params, batch, c: RefCfg):
    """Mean next-token cross entropy plus ``aux_weight`` times the sum of
    the layers' load-balance losses."""
    x = batch["inputs"]
    x = params["embed"][x] if x.dim() == 2 else x.float()
    aux = x.new_zeros(())
    for lp in params["layers"]:
        x, a = checkpoint(block, x, lp, c, use_reentrant=False)
        aux = aux + a
    h = rms_norm(x, params["final_norm"], c.eps)
    logits = h @ params["head"][:, :c.vocab]
    ce = F.cross_entropy(logits.reshape(-1, c.vocab),
                         batch["labels"].reshape(-1).long())
    return ce + c.aux_weight * aux


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    warmup: int
    total: int
    clip: float

    def rate(self, step: int) -> float:
        """Linear warm-up, then cosine decay to a tenth of the peak."""
        warm = min(step / max(self.warmup, 1), 1.0)
        prog = min(max((step - self.warmup)
                       / max(self.total - self.warmup, 1), 0.0), 1.0)
        return self.lr * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(
            math.pi * prog)))


def train_steps(flat: List[torch.Tensor], unflatten, batches, c: RefCfg,
                opt: AdamW, decay: List[bool], watch=None) -> List[float]:
    """Steps of AdamW (global-norm clip, bias correction, decoupled decay
    where ``decay``) on the float32 leaves ``flat`` in place, one per
    batch; returns the losses. ``watch(step, grads, mu)`` sees each
    step's gradients and first moments."""
    mu = [torch.zeros_like(p) for p in flat]
    nu = [torch.zeros_like(p) for p in flat]
    losses = []
    for n, batch in enumerate(batches, start=1):
        leaves = [p.detach().requires_grad_(True) for p in flat]
        loss = loss_fn(unflatten(leaves), batch, c)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        del leaves
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            clip = min(1.0, opt.clip / (float(norm) + 1e-9))
            lr = opt.rate(n)
            for p, g, m, v, dec in zip(flat, grads, mu, nu, decay):
                g.mul_(clip)
                m.mul_(opt.b1).add_(g, alpha=1 - opt.b1)
                v.mul_(opt.b2).addcmul_(g, g, value=1 - opt.b2)
                upd = (m / (1 - opt.b1 ** n)) / (
                    torch.sqrt(v / (1 - opt.b2 ** n)) + opt.eps)
                if dec:
                    upd.add_(p, alpha=opt.weight_decay)
                p.sub_(upd, alpha=lr)
            if watch is not None:
                watch(n, grads, mu)
        del grads
    return losses


def f32_matmuls():
    """Float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def leaves_of(tree) -> List:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves_of(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves_of(v)]
    return [tree]


def rebuild(tree, flat: List) -> object:
    it = iter(flat)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, list):
            return [go(v) for v in t]
        return next(it)
    return go(tree)


def decay_flags(tree) -> List[bool]:
    """Decoupled decay on every leaf inside a layer (the layers' leaves
    are stacks, two-dimensional or more) and on the top-level matrices."""
    out = []
    for k, v in tree.items():
        n = len(leaves_of(v))
        if k == "layers":
            out += [True] * n
        else:
            out += [t.dim() >= 2 for t in leaves_of(v)]
    return out

